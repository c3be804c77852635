"""Decoder arithmetic rules as batched tensor ops.

Counterpart of ``ldpc_toolbox_tpu.decoder.arithmetic``. ``check_messages``
maps the incoming variable messages of every check node, a
``(rows, d, batch)`` block with an optional ``(rows, d)`` validity mask,
to the leave-one-out outgoing messages of the same shape (the reference's
``send_check_messages``, arithmetic.rs:100-102).

All 18 rules of the reference and the min-sum extension: the four float
families (Phi, Tanh, Minstarapprox and Aminstar, arithmetic.rs:158-580,
899-1072), the two i8 families (Minstarapprox and Aminstar, each with its
Jones, PartialHardLimit and Deg1Clip variants, arithmetic.rs:585-1304)
and min-sum. ``var_update(input_llr, c2v, mask)`` is the shared variable
rule "sum minus own contribution" (arithmetic.rs:140-156), with the i8
clips. The lifted decoders run the rules through the kernel rules of
``ops/fused_bp2.py``; ``check_messages`` and ``var_update`` serve the
generic parity-check path (``decoder/flooding.py``, ``decoder/layered.py``)
and the plain layered decode.

Every reduction over the degree axis is a fold in slot order
(``_fold_sum``, the exclusive products of Tanh, the min* folds), so that
a CPU and a CUDA device round the same sums in the same order, the order
in which XLA's CPU reduction adds them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "Arithmetic",
    "AminstarArithmetic",
    "AminstarI8Arithmetic",
    "I8_QUANTIZER_C",
    "MinSumArithmetic",
    "MinstarApproxArithmetic",
    "MinstarApproxI8Arithmetic",
    "PhiArithmetic",
    "TanhArithmetic",
    "i8_correction_table",
]

I8_QUANTIZER_C = 8.0


def i8_correction_table() -> np.ndarray:
    """Quantized ``C*ln(1+e^(-t/C))`` correction lookup (arithmetic.rs:589-602).

    Entry t holds round(8*ln(1+e^(-t/8))) for as long as that rounds
    positive; beyond, zero (the reference's out-of-table lookup returns 0).
    Rounding is half-away-from-zero like Rust's f64::round.
    """
    table = np.zeros(128, dtype=np.int32)
    for t in range(128):
        x = math.floor(I8_QUANTIZER_C * math.log1p(math.exp(-t / I8_QUANTIZER_C)) + 0.5)
        if x <= 0:
            break
        table[t] = x
    return table


def _fold_sum(x, dim=1, keepdim=False):
    """The sum over ``dim`` folded in slot order: ((x0 + x1) + x2) + ..."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc.unsqueeze(dim) if keepdim else acc


@functools.cache
def _fold_slots(d, device):
    """Per folded slot k of a degree-d leave-one-out fold, as (1, d, 1) bool
    tensors on ``device``: ``sel``, the slots j != k that fold k in, and
    ``first``, those whose fold starts at k (the first k != j)."""
    notk = ~np.eye(d, dtype=bool)
    started = np.zeros(d, dtype=bool)
    out = []
    for k in range(d):
        out.append((
            torch.as_tensor(notk[k], device=device)[None, :, None],
            torch.as_tensor(notk[k] & ~started, device=device)[None, :, None],
        ))
        started |= notk[k]
    return tuple(out)


def _first_argmin(mag, vmin):
    """(rows, 1, batch) index of the first slot of ``mag`` (rows, d, batch)
    that equals its minimum ``vmin``, as ``jnp.argmin`` takes it."""
    d = mag.shape[1]
    slot = torch.arange(d, device=mag.device)[None, :, None]
    return torch.where(mag == vmin, slot, d).amin(dim=1, keepdim=True), slot


def _leave_one_out_fold(mag, mask, fold):
    """Each slot's left fold of ``fold`` over the other valid slots of
    ``mag`` (rows, d, batch) in slot order, its first value the first
    other valid slot (arithmetic.rs:487-521); ``mask`` (rows, d) or None
    (every slot valid)."""
    rows, d, _ = mag.shape
    acc = torch.zeros_like(mag)
    if mask is None:
        for k, (sel, first) in enumerate(_fold_slots(d, mag.device)):
            vk = mag[:, k : k + 1, :]
            acc = torch.where(first, vk, torch.where(sel, fold(acc, vk), acc))
        return acc
    cnt = torch.zeros((rows, d, 1), dtype=torch.int32, device=mag.device)
    for k, (sel, _) in enumerate(_fold_slots(d, mag.device)):
        vk = mag[:, k : k + 1, :]
        elig = mask[:, k : k + 1, None] & sel
        first = elig & (cnt == 0)
        acc = torch.where(first, vk, torch.where(elig, fold(acc, vk), acc))
        cnt = cnt + elig.to(torch.int32)
    return acc


def _min_edge_fold(mag, onehot, mask, fold):
    """A-Min*'s fold over the valid slots other than the minimum's
    (``onehot``), in slot order from the first of them: (rows, 1, batch)."""
    rows, d, batch = mag.shape
    acc = torch.zeros((rows, 1, batch), dtype=mag.dtype, device=mag.device)
    cnt = torch.zeros((rows, 1, batch), dtype=torch.int32, device=mag.device)
    for k in range(d):
        vk = mag[:, k : k + 1, :]
        elig = ~onehot[:, k : k + 1, :]
        if mask is not None:
            elig = mask[:, k : k + 1, None] & elig
        first = elig & (cnt == 0)
        acc = torch.where(first, vk, torch.where(elig, fold(acc, vk), acc))
        cnt = cnt + elig.to(torch.int32)
    return acc


def _loo_sign(x, mask_e):
    """Leave-one-out sign parity: for each slot, XOR of the signs of all
    *other* valid slots (mask_e=None means all slots valid). Returns +-1
    int32."""
    neg = x < 0
    if mask_e is not None:
        neg = neg & mask_e
    total_par = neg.sum(dim=-2, keepdim=True, dtype=torch.int32) & 1
    loo_par = total_par ^ neg.to(torch.int32)
    return 1 - 2 * loo_par


class Arithmetic:
    """Base: float LLRs, identity quantization, shared helpers."""

    is_int8 = False

    def __init__(self, dtype=torch.float32):
        self.dtype = dtype

    # dtype the messages are stored in; computation may widen after each
    # load
    @property
    def storage_dtype(self):
        return self.dtype

    @property
    def compute_dtype(self):
        return self.dtype

    # storage dtype of the layered schedule's variable posteriors Qv
    @property
    def var_llr_storage_dtype(self):
        return self.dtype

    def quantize(self, llr):
        """Channel LLR -> internal Llr (input_llr_quantize)."""
        return llr.to(self.dtype)

    def hard_decision(self, llr):
        """llr <= 0 -> bit 1 (the reference's sign convention)."""
        return llr <= 0

    def llr_to_var_llr(self, llr):
        return llr

    def var_llr_to_llr(self, var_llr):
        return var_llr

    def var_update(self, input_llr, c2v, mask=None):
        """The variable rule (arithmetic.rs:140-156): input_llr (n, batch)
        and c2v (n, d, batch), ``mask`` (n, d) or None (every slot a real
        edge) -> (v2c (n, d, batch), the posterior (n, batch)); the
        posterior is input_llr plus the slot-order sum of c2v."""
        inc = c2v if mask is None else torch.where(mask[..., None], c2v, 0)
        total = input_llr + _fold_sum(inc)
        return total[:, None, :] - c2v, total

    def layered_x(self, qv, rold):
        """Extrinsic input for the layered check update: Qv - Rcv."""
        return qv - rold

    def layered_qv_delta(self, rnew, rold):
        """Amount added to Qv after the check update: Rnew - Rold."""
        return rnew - rold


class MinSumArithmetic(Arithmetic):
    """Plain or normalized min-sum (framework extension, not in the
    reference's 18 rules): leave-one-out minimum magnitude by the
    two-minima fold, computed in ``dtype``, messages optionally stored in
    ``storage`` (bfloat16)."""

    def __init__(self, dtype=torch.float32, scale=1.0, storage=None):
        super().__init__(dtype)
        self.scale = scale
        self._storage = storage

    @property
    def storage_dtype(self):
        return self._storage if self._storage is not None else self.dtype

    def check_messages(self, x, mask=None):
        d = x.shape[1]
        big = torch.finfo(self.dtype).max
        if mask is None and d >= 2:
            # two-pass fold over the degree axis: (min1, min2, argmin,
            # sign parity), then each slot's output
            mags = [x[:, k].abs() for k in range(d)]
            negs = [x[:, k] < 0 for k in range(d)]
            m1 = mags[0]
            m2 = torch.full_like(m1, big)
            arg = torch.zeros(m1.shape, dtype=torch.int32, device=x.device)
            par = negs[0]
            for k in range(1, d):
                mk = mags[k]
                m2 = torch.minimum(m2, torch.maximum(m1, mk))
                take = mk < m1
                m1 = torch.where(take, mk, m1)
                arg = torch.where(take, k, arg)
                par = par ^ negs[k]
            outs = []
            for j in range(d):
                loo = torch.where(arg == j, m2, m1)
                if self.scale != 1.0:
                    loo = loo * self.scale
                outs.append(torch.where(par ^ negs[j], -loo, loo))
            return torch.stack(outs, dim=1)

        mask_e = None if mask is None else mask[..., None]
        mag = x.abs()
        if mask_e is not None:
            mag = torch.where(mask_e, mag, big)
        min1, idx1 = mag.min(dim=1, keepdim=True)
        onehot = torch.arange(d, device=x.device)[None, :, None] == idx1
        min2 = torch.where(onehot, big, mag).amin(dim=1, keepdim=True)
        loo_min = torch.where(onehot, min2, min1)
        out = _loo_sign(x, mask_e).to(self.dtype) * loo_min
        if self.scale != 1.0:
            out = out * self.scale
        return out


# -- the float families ----------------------------------------------------------
#
# Messages, posteriors and arithmetic in ``dtype`` (float32, or float64 on
# every device: the card has f64), identity quantization. The lifted
# decoders' check rules are ``ops/fused_bp2.py``'s PhiRule, TanhRule,
# MinstarApproxRule and AminstarRule; ``check_messages`` is the JAX
# package's plane form of each (its ``decoder/arithmetic.py``), which Phi
# computes with expm1 where the kernel rule takes a series.


class PhiArithmetic(Arithmetic):
    """phi involution sum-product (arithmetic.rs:158-298): each output is
    phi(sum of the inputs' phis - its own) with the parity of the other
    signs; phi(x) = ln(1 + e^-x) - ln(1 - e^-x), x at least 1e-30, with
    ln(1 - e^-x) as log1p(-e^-x) below e^-x = 1/2 and log(-expm1(-x))
    above."""

    MIN_X = 1e-30

    def _phi(self, x):
        x = torch.clamp_min(x, self.MIN_X)
        t = torch.exp(-x)
        ln_1mt = torch.where(t < 0.5, torch.log1p(-t), torch.log(-torch.expm1(-x)))
        return torch.log1p(t) - ln_1mt

    def check_messages(self, x, mask=None):
        mask_e = None if mask is None else mask[..., None]
        phi_x = self._phi(x.abs())
        inc = phi_x if mask_e is None else torch.where(mask_e, phi_x, 0)
        y = self._phi(_fold_sum(inc, keepdim=True) - phi_x)
        return _loo_sign(x, mask_e).to(self.dtype) * y


class TanhArithmetic(Arithmetic):
    """tanh product rule (arithmetic.rs:300-435) with the reference's input
    clamp (18.0 for f64, 9.0 for f32, where tanh still rounds below 1) and
    the product clamp to the largest value below 1 in ``dtype``, which
    keeps 2 atanh finite wherever tanh rounds to 1."""

    def __init__(self, dtype=torch.float32, clamp=None):
        super().__init__(dtype)
        if clamp is None:
            clamp = 18.0 if dtype == torch.float64 else 9.0
        self.clamp = clamp
        one = np.ones((), np.float64 if dtype == torch.float64 else np.float32)
        self.prod_max = float(np.nextafter(one, one * 0))

    def check_messages(self, x, mask=None):
        """2 atanh of the product of the other slots' tanh(x / 2), by
        exclusive prefix and suffix products (no division: tanh can be 0),
        each folded in slot order; a masked slot counts as tanh = 1."""
        t = torch.tanh(torch.clamp(0.5 * x, -self.clamp, self.clamp))
        if mask is not None:
            t = torch.where(mask[..., None], t, 1.0)
        ts = t.unbind(1)
        d = len(ts)
        pre, suf = [torch.ones_like(ts[0])], [torch.ones_like(ts[0])]
        for k in range(1, d):
            pre.append(ts[0] if k == 1 else pre[-1] * ts[k - 1])
            suf.append(ts[d - 1] if k == 1 else suf[-1] * ts[d - k])
        prod = torch.stack(pre, 1) * torch.stack(suf[::-1], 1)
        return 2.0 * torch.atanh(torch.clamp(prod, -self.prod_max, self.prod_max))


class MinstarApproxArithmetic(Arithmetic):
    """Pairwise min* approximation in the reference's fold order
    (arithmetic.rs:487-521): ``max(min(a, b) - ln(1 + e^-|a - b|), 0)``."""

    @staticmethod
    def _fold_op(acc, v):
        return torch.clamp_min(
            torch.minimum(acc, v) - torch.log1p(torch.exp(-(acc - v).abs())), 0.0
        )

    def check_messages(self, x, mask=None):
        mask_e = None if mask is None else mask[..., None]
        acc = _leave_one_out_fold(x.abs(), mask, self._fold_op)
        return _loo_sign(x, mask_e).to(self.dtype) * acc


class AminstarArithmetic(Arithmetic):
    """A-Min*-BP (arithmetic.rs:899-1072): the exact min* of the edges other
    than the least, shared with min* of the least by the others."""

    @staticmethod
    def _minstar_full(a, b):
        return (
            torch.minimum(a, b)
            - torch.log1p(torch.exp(-(a - b).abs()))
            + torch.log1p(torch.exp(-(a + b)))
        )

    def check_messages(self, x, mask=None):
        mask_e = None if mask is None else mask[..., None]
        big = torch.finfo(self.dtype).max
        mag = x.abs()
        masked_mag = mag if mask_e is None else torch.where(mask_e, mag, big)
        vmin = masked_mag.amin(dim=1, keepdim=True)
        argmin, slot = _first_argmin(masked_mag, vmin)
        onehot = slot == argmin
        delta = _min_edge_fold(mag, onehot, mask, self._minstar_full)
        magnitude = torch.where(onehot, delta, self._minstar_full(delta, vmin))
        return _loo_sign(x, mask_e).to(self.dtype) * magnitude


# -- the i8 families -----------------------------------------------------------
#
# Messages are int8-valued but computed in int32 (identical results: every
# reference step clips into i8/i16 range before use). The variable LLR domain
# is int16-valued (VarLlr = i16, arithmetic.rs:684-688).


def _clip127(x):
    return x.clamp(-127, 127)


def _partial_hard_limit(x):
    # arithmetic.rs:812-824
    return torch.where(x <= -100, -127, torch.where(x >= 100, 127, x))


class _I8Base(Arithmetic):
    is_int8 = True

    def __init__(self, jones: bool = False, hard_limit: bool = False,
                 deg1_clip: bool = False):
        super().__init__(torch.int8)
        self.jones = jones
        self.hard_limit = hard_limit
        self.deg1_clip = deg1_clip
        self._table = torch.from_numpy(i8_correction_table())
        self._tables = {}

    @property
    def storage_dtype(self):
        return torch.int8

    @property
    def compute_dtype(self):
        return torch.int32

    @property
    def var_llr_storage_dtype(self):
        return torch.int16

    def quantize(self, llr):
        """C=8 quantizer with +-127 saturation and half-away rounding
        (arithmetic.rs:690-699), in f32 as the JAX package computes it:
        ``sign(x) * floor(|x| + 0.5)`` of ``x = 8 * llr``, so a value just
        under a half whose ``|x| + 0.5`` rounds up to 1 in f32 goes to 1."""
        x = I8_QUANTIZER_C * llr.to(torch.float32)
        r = (torch.sign(x) * torch.floor(x.abs() + 0.5)).to(torch.int32)
        return torch.where(x >= 127.0, 127, torch.where(x <= -127.0, -127, r))

    def llr_to_var_llr(self, llr):
        return llr

    def var_llr_to_llr(self, var_llr):
        return _clip127(var_llr)

    def _lookup(self, t):
        """table[t] for t >= 0: the table's entry in [0, 127], 0 beyond
        (arithmetic.rs:604-607; the table's last entry is 0), a gather
        from the table's copy on t's device."""
        table = self._tables.get(t.device)
        if table is None:
            table = self._tables[t.device] = self._table.to(t.device)
        return table[t.clamp_max(127)].to(t.dtype)

    def var_update(self, input_llr, c2v, mask=None):
        """The variable rule with its clips (arithmetic.rs:622-654):
        input_llr (n, batch) and c2v (n, d, batch) int32 -> (v2c (n, d,
        batch), the clipped posterior (n, batch))."""
        inp = input_llr
        if self.deg1_clip:
            if mask is None:
                if c2v.shape[1] == 1:
                    inp = input_llr.clamp(-116, 116)
            else:
                deg = mask.sum(dim=1, dtype=torch.int32)
                inp = torch.where(
                    (deg == 1)[:, None], input_llr.clamp(-116, 116), input_llr
                )
        inc = c2v if mask is None else torch.where(mask[..., None], c2v, 0)
        total = inp + inc.sum(dim=1, dtype=torch.int32)
        if self.jones:
            total = _clip127(total)
        v2c = _clip127(total[:, None, :] - c2v)
        return v2c, _clip127(total)

    def layered_x(self, qv, rold):
        # x = clip(vars[dest] - i16(rcv))
        return _clip127(qv.to(torch.int32) - rold)

    def layered_qv_delta(self, rnew, rold):
        return rnew - rold


class MinstarApproxI8Arithmetic(_I8Base):
    """Quantized pairwise min* with table-lookup correction
    (arithmetic.rs:718-754): fold over the other valid slots in order with
    ``max(min(acc,v) - table[|acc-v|], 0)``; optional partial hard limit on
    the signed output."""

    def _fold(self, acc, vk):
        return torch.clamp_min(
            torch.minimum(acc, vk) - self._lookup((acc - vk).abs()), 0
        )

    def check_messages(self, x, mask=None):
        mask_e = None if mask is None else mask[..., None]
        acc = _leave_one_out_fold(x.abs(), mask, self._fold)
        out = _loo_sign(x, mask_e) * acc
        if self.hard_limit:
            out = _partial_hard_limit(out)
        return out


class AminstarI8Arithmetic(_I8Base):
    """Quantized A-Min*-BP (arithmetic.rs:1129-1192): full min* fold (both
    correction lookups, saturating add) against non-minimum edges."""

    def _minstar_full(self, a, b):
        return torch.clamp_min(
            torch.minimum(a, b)
            - self._lookup((a - b).abs())
            + self._lookup(torch.clamp_max(a + b, 127)),
            0,
        )

    def check_messages(self, x, mask=None):
        mask_e = None if mask is None else mask[..., None]
        mag = x.abs()
        masked_mag = mag if mask_e is None else torch.where(mask_e, mag, 128)
        vmin = masked_mag.amin(dim=1, keepdim=True)
        argmin, slot = _first_argmin(masked_mag, vmin)
        onehot = slot == argmin
        delta = _min_edge_fold(mag, onehot, mask, self._minstar_full)
        delta_min_edge = _partial_hard_limit(delta) if self.hard_limit else delta
        delta_others = self._minstar_full(delta, vmin)
        if self.hard_limit:
            delta_others = _partial_hard_limit(delta_others)
        magnitude = torch.where(onehot, delta_min_edge, delta_others)
        return _loo_sign(x, mask_e) * magnitude
