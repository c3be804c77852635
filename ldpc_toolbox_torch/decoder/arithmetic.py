"""Decoder arithmetic rules as batched tensor ops.

Counterpart of ``ldpc_toolbox_tpu.decoder.arithmetic``. ``check_messages``
maps the incoming variable messages of every check node, a
``(rows, d, batch)`` block with an optional ``(rows, d)`` validity mask,
to the leave-one-out outgoing messages of the same shape (the reference's
``send_check_messages``, arithmetic.rs:100-102).

Only the min-sum extension is ported so far. The Phi, Tanh, Minstarapprox
and Aminstar families and the i8 families wait (ROADMAP A6).
"""

from __future__ import annotations

import torch

__all__ = ["Arithmetic", "MinSumArithmetic"]


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
