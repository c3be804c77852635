"""Flat decode layout, per-plane rules and the flooding phase kernels.

Counterpart of ``ldpc_toolbox_tpu.ops.fused_bp2``. The layout is numpy and
built once per code (``var_recon_tables`` adds the var-major tables the
compressed flooding decode rebuilds its messages through); the rules are
plain functions on torch tensors, the plain versions of what the CUDA
kernels inline.

Every message plane is stored once, in its consumer's lane coordinates
and in consumer-major order: check-major ``(E, Z, B)`` planes for the
check side, var-major for the variable side. Moving a plane between the
two sides is a roll by the edge's lift shift. Incomplete circulants (the
DVB-S2 staircase corner) have one missing lane per affected edge: a check
update sees ``big`` there (min-sum ignores it) and emits 0 there.

The streaming flooding phases work on frame tiles, ``(nbt, P, Z, Bt)``
planes with frames innermost:

* ``fused_check``: v2c (check-major, check coordinates) -> c2v
  (var-major, var coordinates), 0 at the missing lanes;
* ``fused_var``: c2v and the channel planes q -> v2c, big at the missing
  lanes, and the posterior hard bits; ``c2v=None`` is the flooding
  initialisation (every output is q);
* ``fused_syndrome_bits``: hard bits -> one "unsatisfied check" flag a
  frame;
* ``fused_syndrome_freeze``: the same syndrome, and the streaming loop's
  freeze in place (the frames that pass for the first time get their
  iteration and their bits frozen) and its count of unconverged frames.

On a CUDA tensor each launches its hand-written kernel or raises: the
check and variable phases are the templates of ``csrc/streaming.cuh``
(a thread per lane of a tile's 4 frames), instantiated on the rule's
family, min-sum in ``csrc/flooding.cu``, the i8 rules in
``csrc/flooding_i8.cu`` (``fused_check_i8``, ``fused_var_i8``), the float
rules in ``csrc/flooding_f32.cu`` and ``_f64.cu`` (``fused_check_float``,
``fused_var_float``); each family counts its launches apart. The two
syndrome wrappers launch ``fused_syndrome_kernel`` of ``csrc/flooding.cu``
(rule-free; a thread per check lane of a tile's 4 frames) and count
their launches apart. On a CPU
tensor each runs its plain version (the ``*_reference`` functions, in the
rule's compute type). A roll by s means ``out[i] = x[(i - s) mod Z]``, on
unpadded planes.

The rules, which the resident message kernels inline: ``MinSumRule``; the
two i8 rules, ``MinstarApproxI8Rule`` and ``AminstarI8Rule`` (int8
messages, int32 compute, int16 layered posteriors); and the four float
rules, ``PhiRule``, ``TanhRule``, ``MinstarApproxRule`` and
``AminstarRule`` (f32 or f64 messages, posteriors and compute).
"""

from __future__ import annotations

from dataclasses import dataclass

import ctypes
import functools

import numpy as np
import torch

from . import _build

__all__ = [
    "BT",
    "FusedLayout",
    "build_fused_layout",
    "MinSumRule",
    "PhiRule",
    "TanhRule",
    "MinstarApproxRule",
    "AminstarRule",
    "MinstarApproxI8Rule",
    "AminstarI8Rule",
    "check_degree_cap",
    "is_float_rule",
    "is_i8",
    "takes_storage",
    "rule_for",
    "var_recon_tables",
    "fused_check",
    "fused_check_float",
    "fused_check_i8",
    "fused_check_reference",
    "fused_var",
    "fused_var_float",
    "fused_var_i8",
    "fused_var_reference",
    "fused_syndrome_bits",
    "fused_syndrome_bits_reference",
    "fused_syndrome_freeze",
    "fused_syndrome_freeze_reference",
    "freeze_on_flags",
    "i8_steps",
    "i8_steps_reference",
]

#: frames per tile of the port's kernels: B = 1024 gives 256 tiles, about
#: two per SM of an H100 (132 SMs), with frames innermost and coalesced
BT = 4
#: the check kernels keep the signs of a group's inputs in 64 bits
MAX_CHECK_DEGREE = 64
#: the largest check degree of the kernels' exact-order min* folds (the i8
#: rules and MinstarApproxRule): O(d^2), unrolled to the degree bucket (8,
#: 16 or 32)
I8_MAX_CHECK_DEGREE = 32


@dataclass(frozen=True)
class _SideMeta:
    """Static per-bucket metadata: groups [g0, g1) with degree d whose
    first edge (in this side's flat consumer-major order) is ebase."""

    g0: int
    g1: int
    d: int
    ebase: int


@dataclass(frozen=True)
class FusedLayout:
    """Flat index arrays, built once per code.

    Edge flat orders: ``chk_*`` arrays are check-major (the order of
    ``v2c`` planes), ``var_*`` arrays are var-major (the order of ``c2v``
    planes). ``rot`` entries are roll amounts applied to a producer's
    output plane to bring it into the consumer's lane coordinates;
    ``omask``/``syn_mask`` is the single missing lane (-1 = none).
    """

    Z: int
    E: int  # base edges
    CG: int  # check groups (flattened, bucket-major)
    VG: int  # var groups (flattened, bucket-major)

    chk_meta: tuple  # tuple[_SideMeta], layer order
    var_meta: tuple

    chk_cs: np.ndarray  # (CG,) first edge of each check group
    chk_dest: np.ndarray  # (E,) var-major dest plane in c2v
    chk_rot: np.ndarray  # (E,) roll check->var = (Z - s) % Z
    chk_omask: np.ndarray  # (E,) missing lane in var coords, -1 none

    var_cs: np.ndarray  # (VG,) chunk start plane in c2v
    var_dest: np.ndarray  # (E,) check-major dest plane in v2c
    var_rot: np.ndarray  # (E,) roll var->check = s
    var_omask: np.ndarray  # (E,) missing lane in check coords, -1 none

    syn_vg: np.ndarray  # (E,) check-major: var-group plane of each edge
    syn_rot: np.ndarray  # (E,) roll var->check = s
    syn_mask: np.ndarray  # (E,) missing lane in check coords, -1 none

    cm_vg: np.ndarray  # (E,) check-major edge -> var group (bucket order)
    cm_shift: np.ndarray  # (E,) edge lift shift s

    @property
    def max_chk_degree(self) -> int:
        return max((m.d for m in self.chk_meta), default=0)

    @property
    def max_var_degree(self) -> int:
        return max((m.d for m in self.var_meta), default=0)


def build_fused_layout(lg) -> FusedLayout:
    """Build the flat layout from a ``decoder.lifted.LiftedGraph``.

    Raises ValueError for graphs whose incomplete circulants are missing
    more than one lane per edge (no standards family here does that).
    """
    Z = lg.Z
    E = lg.num_base_edges

    def metas(buckets):
        out = []
        g0 = 0
        ebase = 0
        for b in buckets:
            n = len(b.groups)
            if n == 0:
                continue
            out.append(_SideMeta(g0=g0, g1=g0 + n, d=b.degree, ebase=ebase))
            g0 += n
            ebase += n * b.degree
        return tuple(out), g0, ebase

    chk_meta, CG, ce = metas(lg.chk_buckets)
    var_meta, VG, ve = metas(lg.var_buckets)
    assert ce == E and ve == E, (ce, ve, E)

    chk_cs = np.empty(CG, np.int32)
    for m in chk_meta:
        chk_cs[m.g0 : m.g1] = m.ebase + np.arange(m.g1 - m.g0) * m.d
    var_cs = np.empty(VG, np.int32)
    for m in var_meta:
        var_cs[m.g0 : m.g1] = m.ebase + np.arange(m.g1 - m.g0) * m.d

    def flat(buckets, attr):
        parts = [
            getattr(b, attr).reshape(-1)
            for b in buckets
            if len(b.groups) and b.degree
        ]
        return (
            np.concatenate(parts).astype(np.int32)
            if parts
            else np.zeros(0, np.int32)
        )

    chk_dest = flat(lg.chk_buckets, "planes")  # vm position
    chk_s = flat(lg.chk_buckets, "shifts")  # +s
    chk_rot = ((Z - chk_s) % Z).astype(np.int32)
    syn_vg = flat(lg.chk_buckets, "var_group_pos")
    syn_rot = chk_s.copy()

    var_dest = flat(lg.var_buckets, "planes")  # cm position
    var_ms = flat(lg.var_buckets, "shifts")  # (-s) % Z
    var_rot = ((Z - var_ms) % Z).astype(np.int32)

    chk_omask = np.full(E, -1, np.int32)
    var_omask = np.full(E, -1, np.int32)
    syn_mask = np.full(E, -1, np.int32)
    for vm_posn, cm_posn, lanes_c, lanes_v in lg.missing:
        if len(lanes_c) != 1:
            raise ValueError("the layout supports single-lane circulant gaps only")
        chk_omask[cm_posn] = int(lanes_v[0])
        var_omask[vm_posn] = int(lanes_c[0])
        syn_mask[cm_posn] = int(lanes_c[0])

    return FusedLayout(
        Z=Z,
        E=E,
        CG=CG,
        VG=VG,
        chk_meta=chk_meta,
        var_meta=var_meta,
        chk_cs=chk_cs,
        chk_dest=chk_dest,
        chk_rot=chk_rot,
        chk_omask=chk_omask,
        var_cs=var_cs,
        var_dest=var_dest,
        var_rot=var_rot,
        var_omask=var_omask,
        syn_vg=syn_vg,
        syn_rot=syn_rot,
        syn_mask=syn_mask,
        cm_vg=syn_vg.copy(),
        cm_shift=chk_s.copy(),
    )


def var_recon_tables(layout):
    """For each var-major edge p (the c2v plane the variable side reads):
    the check-major edge that feeds it (its sign plane), its check group,
    its slot in that group and its check->var roll. The compressed
    flooding decode rebuilds c2v from the check state through them.
    Numpy copy of the JAX package's ``ops/resident_compressed.py
    _var_recon_tables``; works on either package's layout."""
    E = layout.E
    plane = np.empty(E, np.int32)
    group = np.empty(E, np.int32)
    slot = np.empty(E, np.int32)
    rot = np.empty(E, np.int32)
    e = 0
    for m in layout.chk_meta:
        for g in range(m.g0, m.g1):
            cs = int(layout.chk_cs[g])
            for t in range(m.d):
                p = int(layout.chk_dest[e])
                plane[p] = cs + t
                group[p] = g
                slot[p] = t
                rot[p] = int(layout.chk_rot[e])
                e += 1
    return plane, group, slot, rot


class MinSumRule:
    """(Normalized) min-sum over float planes: the min1/min2/argmin/
    sign-parity fold that ``csrc/resident_layered.cu`` inlines, in the
    same order and with the same rounding points."""

    compute_dtype = torch.float32
    max_check_degree = MAX_CHECK_DEGREE

    def __init__(self, dtype, scale: float = 1.0):
        self.storage_dtype = dtype
        # missing-lane poke and initial second minimum
        self.big = float(torch.finfo(dtype).max)
        self.scale = float(scale)

    def fold(self, planes):
        """The check state of d planes (a list, or a tensor with the d
        planes on dim 0) of f32 extrinsics: (m1, m2, arg, par, negs), the
        smallest |x| (the first wins a tie), the second smallest (folded
        as min(m2, max(m1, |x|)) from big), the slot of m1, the parity of
        the signs (x < 0) and the list of the d signs. Unscaled."""
        mags = [x.abs() for x in planes]
        negs = [x < 0 for x in planes]
        m1 = mags[0]
        m2 = torch.full_like(m1, self.big)
        arg = torch.zeros(m1.shape, dtype=torch.int32, device=m1.device)
        par = negs[0]
        for k in range(1, len(planes)):
            mk = mags[k]
            m2 = torch.minimum(m2, torch.maximum(m1, mk))
            take = mk < m1
            m1 = torch.where(take, mk, m1)
            arg = torch.where(take, k, arg)
            par = par ^ negs[k]
        return m1, m2, arg, par, negs

    def check(self, planes) -> torch.Tensor:
        """d planes (a list, or a tensor with the d planes on dim 0) of
        f32 extrinsics -> the (d, ...) stacked f32 check outputs."""
        m1, m2, arg, par, negs = self.fold(planes)
        outs = []
        for t in range(len(planes)):
            loo = torch.where(arg == t, m2, m1)
            if self.scale != 1.0:
                loo = loo * self.scale
            outs.append(torch.where(par ^ negs[t], -loo, loo))
        return torch.stack(outs)

    def var(self, q, xs, degree):
        """Sum-minus-own variable rule, summed in slot order as the kernels
        do: (the d extrinsic outputs, the posterior)."""
        tot = q
        for x in xs:
            tot = tot + x
        return [tot - x for x in xs], tot

    # layered-schedule helper (horizontal_layered.rs:105-110)
    def layered_x(self, qv, rold):
        return qv - rold


class _FloatRuleBase:
    """The float rules: f32 or f64 storage, computed in f32 (f64 when the
    storage is f64), the plain sum-minus-own variable rule
    (arithmetic.rs:140-156) and the Qv - Rcv layered extrinsic. ``kind``
    names the rule to the kernels' float instances; ``big``, the
    missing-lane poke, is the storage type's largest value, which each
    rule treats as an infinitely reliable bit-0 message (phi -> 0, tanh ->
    tanh(clamp), min* -> neutral)."""

    max_check_degree = MAX_CHECK_DEGREE
    #: Tanh's input and product clamps (0 for the other rules, which the
    #: kernels take them from too)
    clamp = prod_max = 0.0

    def __init__(self, dtype):
        self.storage_dtype = dtype
        self.compute_dtype = torch.float64 if dtype == torch.float64 else torch.float32
        self.big = float(torch.finfo(dtype).max)

    def var(self, q, xs, degree):
        """Sum-minus-own in slot order: (the d outputs, the posterior)."""
        tot = q
        for x in xs:
            tot = tot + x
        return [tot - x for x in xs], tot

    def layered_x(self, qv, rold):
        return qv - rold

    def _const(self, value, like):
        """``value`` as a 0-d tensor of the compute type on like's device."""
        return torch.tensor(value, dtype=self.compute_dtype, device=like.device)

    @staticmethod
    def _parity(planes):
        negs = [x < 0 for x in planes]
        par = negs[0]
        for k in range(1, len(planes)):
            par = par ^ negs[k]
        return negs, par


class PhiRule(_FloatRuleBase):
    """phi-involution sum-product (arithmetic.rs:158-298): the sum of the
    inputs' phis, each output phi(sum - own phi) with the parity of the
    other signs. phi(x) = ln(1 + e^-x) - ln(1 - e^-x), x at least 1e-30,
    with 1 - e^-x as a 3-term series below 2^-5 (the JAX kernel rule's
    form, not the plane path's expm1)."""

    kind = 0
    MIN_X = 1e-30

    def _phi(self, x):
        x = torch.maximum(x, self._const(self.MIN_X, x))
        t = torch.exp(-x)
        series = x * ((1.0 - 0.5 * x) + self._const(1.0 / 6.0, x) * (x * x))
        one_minus_t = torch.where(x < 0.03125, series, 1.0 - t)
        ln_1mt = torch.where(t < 0.5, torch.log1p(-t), torch.log(one_minus_t))
        return torch.log1p(t) - ln_1mt

    def check(self, planes) -> torch.Tensor:
        """d planes (a list, or a tensor with the d planes on dim 0) in the
        compute type -> the (d, ...) stacked check outputs."""
        d = len(planes)
        negs, par = self._parity(planes)
        phis = [self._phi(x.abs()) for x in planes]
        tot = phis[0]
        for k in range(1, d):
            tot = tot + phis[k]
        outs = []
        for t in range(d):
            y = self._phi(tot - phis[t])
            outs.append(torch.where(par ^ negs[t], -y, y))
        return torch.stack(outs)


class TanhRule(_FloatRuleBase):
    """tanh product rule (arithmetic.rs:300-435): 2 atanh of the product of
    the other slots' tanh(x / 2), x / 2 clamped to +-clamp, the product by
    exclusive prefix and suffix products (``pre[t] * suf[t]``, no
    division) clamped to +-prod_max, and 2 atanh(p) as log1p(p) -
    log1p(-p). The signs ride inside the product."""

    kind = 1

    def __init__(self, dtype, clamp, prod_max):
        super().__init__(dtype)
        self.clamp = float(clamp)
        self.prod_max = float(prod_max)

    def check(self, planes) -> torch.Tensor:
        d = len(planes)
        ts = [torch.tanh(torch.clamp(0.5 * x, -self.clamp, self.clamp)) for x in planes]
        pre = [None] * d
        acc = None
        for k in range(d):
            pre[k] = acc
            acc = ts[k] if acc is None else acc * ts[k]
        suf = [None] * d
        acc = None
        for k in reversed(range(d)):
            suf[k] = acc
            acc = ts[k] if acc is None else acc * ts[k]
        outs = []
        for t in range(d):
            p, s = pre[t], suf[t]
            if p is None and s is None:  # a degree-1 check: the empty product
                prod = torch.ones_like(ts[t])
            else:
                prod = s if p is None else p if s is None else p * s
            prod = torch.clamp(prod, -self.prod_max, self.prod_max)
            outs.append(torch.log1p(prod) - torch.log1p(-prod))
        return torch.stack(outs)


class MinstarApproxRule(_FloatRuleBase):
    """Pairwise min* approximation in the reference's fold order
    (arithmetic.rs:487-521): each slot's left fold over the other slots in
    slot order, with the prefixes of the slots before it reused;
    ``fold(a, b) = max(min(a, b) - log1p(exp(-|a - b|)), 0)``. The kernels
    unroll the O(d^2) fold to the degree bucket, so they take check degree
    up to 32."""

    kind = 2
    max_check_degree = I8_MAX_CHECK_DEGREE

    def _fold(self, a, b):
        return torch.clamp_min(
            torch.minimum(a, b) - torch.log1p(torch.exp(-(a - b).abs())), 0.0
        )

    def check(self, planes) -> torch.Tensor:
        d = len(planes)
        negs, par = self._parity(planes)
        mags = [x.abs() for x in planes]
        pre = [None] * d
        acc = None
        for t in range(d):
            pre[t] = acc
            acc = mags[t] if acc is None else self._fold(acc, mags[t])
        outs = []
        for t in range(d):
            a = pre[t]
            for k in range(t + 1, d):
                a = mags[k] if a is None else self._fold(a, mags[k])
            if a is None:  # degree-1 check: no other edges
                a = torch.zeros_like(mags[t])
            outs.append(torch.where(par ^ negs[t], -a, a))
        return torch.stack(outs)


class AminstarRule(_FloatRuleBase):
    """A-Min*-BP (arithmetic.rs:899-1072): the first minimum's slot gets the
    exact min* fold of the other slots (from the first of them, in slot
    order), every other slot min*(fold, minimum); ``min*(a, b) = min(a, b)
    - log1p(exp(-|a - b|)) + log1p(exp(-(a + b)))``."""

    kind = 3

    def _minstar_full(self, a, b):
        return (
            torch.minimum(a, b)
            - torch.log1p(torch.exp(-(a - b).abs()))
            + torch.log1p(torch.exp(-(a + b)))
        )

    def check(self, planes) -> torch.Tensor:
        d = len(planes)
        negs, par = self._parity(planes)
        mags = [x.abs() for x in planes]
        m1 = mags[0]
        arg = torch.zeros(m1.shape, dtype=torch.int32, device=m1.device)
        for k in range(1, d):
            take = mags[k] < m1
            m1 = torch.where(take, mags[k], m1)
            arg = torch.where(take, k, arg)
        acc = torch.zeros_like(m1)
        cnt = torch.zeros(m1.shape, dtype=torch.int32, device=m1.device)
        for k in range(d):
            elig = arg != k
            first = elig & (cnt == 0)
            folded = self._minstar_full(acc, mags[k])
            acc = torch.where(first, mags[k], torch.where(elig, folded, acc))
            cnt = cnt + elig.to(torch.int32)
        d_oth = self._minstar_full(acc, m1)
        outs = []
        for t in range(d):
            mag = torch.where(arg == t, acc, d_oth)
            outs.append(torch.where(par ^ negs[t], -mag, mag))
        return torch.stack(outs)


def _i8_thresholds():
    """The i8 correction table (arithmetic.rs:589-602) as compare
    thresholds: table[t] == sum_k [t <= T_k], the table being
    non-increasing. ``csrc/i8.cuh`` compiles them in as ``kI8Thresholds``."""
    from ..decoder.arithmetic import i8_correction_table

    tab = i8_correction_table()
    assert (np.diff(tab) <= 0).all()
    return [int(np.max(np.nonzero(tab >= k)[0])) for k in range(1, int(tab[0]) + 1)]


def _phl(x):
    """Partial hard limit (arithmetic.rs:812-824)."""
    return torch.where(x <= -100, -127, torch.where(x >= 100, 127, x))


class _I8RuleBase:
    """The i8 rules: int8 storage, int32 compute, int16 layered posteriors
    and the reference's clips (arithmetic.rs:585-897). ``jones``,
    ``hard_limit`` and ``deg1_clip`` give the 8 variants of a family;
    ``kind`` names the family to the kernels and ``flags`` the variant."""

    storage_dtype = torch.int8
    compute_dtype = torch.int32
    max_check_degree = I8_MAX_CHECK_DEGREE
    #: the missing-lane poke of x (the one-lane i8 approximation)
    big = 127

    def __init__(self, jones=False, hard_limit=False, deg1_clip=False):
        self.jones = jones
        self.hard_limit = hard_limit
        self.deg1_clip = deg1_clip
        self.thr = _i8_thresholds()

    @property
    def flags(self) -> int:
        """The variant as the kernels take it: bit 0 PartialHardLimit,
        bit 1 Jones, bit 2 Deg1Clip."""
        return int(self.hard_limit) | int(self.jones) << 1 | int(self.deg1_clip) << 2

    def _tab(self, t):
        """The correction table at t in [0, 127] as a balanced select tree
        over the thresholds (JAX ``_tab_tree``, the same values as the
        table)."""
        bps = sorted(self.thr)
        vals = list(range(len(bps), -1, -1))

        def tree(bps, vals):
            if len(vals) == 1:
                return torch.full_like(t, vals[0])
            mid = len(bps) // 2
            left = tree(bps[:mid], vals[: mid + 1])
            right = tree(bps[mid + 1 :], vals[mid + 1 :])
            return torch.where(t <= bps[mid], left, right)

        return tree(bps, vals)

    @staticmethod
    def _signs(planes):
        negs = [x < 0 for x in planes]
        par = negs[0]
        for k in range(1, len(planes)):
            par = par ^ negs[k]
        return negs, par

    def var(self, q, xs, degree):
        """Sum-minus-own with the clips: (the d outputs clipped to +-127,
        the posterior total), the Deg1Clip of q for a degree-1 group and
        the Jones clip of the total."""
        inp = q.clamp(-116, 116) if (self.deg1_clip and degree == 1) else q
        tot = inp
        for x in xs:
            tot = tot + x
        if self.jones:
            tot = tot.clamp(-127, 127)
        return [(tot - x).clamp(-127, 127) for x in xs], tot

    # x = clip(Qv - Rcv) with int16 posteriors (arithmetic.rs:684-688)
    def layered_x(self, qv, rold):
        return (qv.to(torch.int32) - rold).clamp(-127, 127)


class MinstarApproxI8Rule(_I8RuleBase):
    """Quantized pairwise min* (arithmetic.rs:718-754): the exact left fold
    of the other slots in slot order, with prefix reuse, as the kernels
    compute it."""

    kind = 0

    def _fold(self, a, b):
        return torch.clamp_min(torch.minimum(a, b) - self._tab((a - b).abs()), 0)

    def check(self, planes) -> torch.Tensor:
        """d int32 planes (a list, or a tensor with the d planes on dim 0)
        -> the (d, ...) stacked int32 check outputs."""
        d = len(planes)
        mags = [x.abs() for x in planes]
        negs, par = self._signs(planes)
        pre = [None] * d
        acc = None
        for t in range(d):
            pre[t] = acc
            acc = mags[t] if acc is None else self._fold(acc, mags[t])
        outs = []
        for t in range(d):
            a = pre[t]
            for k in range(t + 1, d):
                a = mags[k] if a is None else self._fold(a, mags[k])
            if a is None:  # degree-1 check: no other edges
                a = torch.zeros_like(mags[t])
            o = torch.where(par ^ negs[t], -a, a)
            outs.append(_phl(o) if self.hard_limit else o)
        return torch.stack(outs)


class AminstarI8Rule(_I8RuleBase):
    """Quantized A-Min*-BP (arithmetic.rs:1129-1192): the first minimum's
    slot, a full min* fold over the other slots; the minimum's slot gets
    the fold, every other slot min*(fold, minimum)."""

    kind = 1

    def _minstar_full(self, a, b):
        return torch.clamp_min(
            torch.minimum(a, b)
            - self._tab((a - b).abs())
            + self._tab(torch.clamp_max(a + b, 127)),
            0,
        )

    def check(self, planes) -> torch.Tensor:
        d = len(planes)
        mags = [x.abs() for x in planes]
        negs, par = self._signs(planes)
        m1 = mags[0]
        arg = torch.zeros(m1.shape, dtype=torch.int32, device=m1.device)
        for k in range(1, d):
            take = mags[k] < m1
            m1 = torch.where(take, mags[k], m1)
            arg = torch.where(take, k, arg)
        acc = torch.zeros_like(m1)
        cnt = torch.zeros(m1.shape, dtype=torch.int32, device=m1.device)
        for k in range(d):
            elig = arg != k
            first = elig & (cnt == 0)
            folded = self._minstar_full(acc, mags[k])
            acc = torch.where(first, mags[k], torch.where(elig, folded, acc))
            cnt = cnt + elig.to(torch.int32)
        d_min = _phl(acc) if self.hard_limit else acc
        d_oth = self._minstar_full(acc, m1)
        if self.hard_limit:
            d_oth = _phl(d_oth)
        outs = []
        for t in range(d):
            mag = torch.where(arg == t, d_min, d_oth)
            outs.append(torch.where(par ^ negs[t], -mag, mag))
        return torch.stack(outs)


def is_i8(rule) -> bool:
    """Whether a kernel rule is one of the i8 rules (int8 messages)."""
    return isinstance(rule, _I8RuleBase)


def is_float_rule(rule) -> bool:
    """Whether a kernel rule is one of the four float rules (Phi, Tanh,
    MinstarApprox, Aminstar)."""
    return isinstance(rule, _FloatRuleBase)


def takes_storage(rule) -> bool:
    """Whether the kernels of the rule's family take its message storage
    type: the min-sum kernels f32 and bf16 (``_MSG_DTYPES``), the i8
    instances int8, the float-rule instances f32 and f64."""
    if is_i8(rule):
        return rule.storage_dtype == torch.int8
    if is_float_rule(rule):
        return rule.storage_dtype in (torch.float32, torch.float64)
    return rule.storage_dtype in _MSG_DTYPES


def check_degree_cap(layout, rule) -> None:
    """Raise a ValueError when the layout's widest check is wider than the
    rule's kernels take (``rule.max_check_degree``); the decoders ask it on
    every device."""
    if layout.max_chk_degree > rule.max_check_degree:
        raise ValueError(
            f"check degree {layout.max_chk_degree} above "
            f"{rule.max_check_degree}, the most the kernels of "
            f"{type(rule).__name__} take"
        )


def rule_for(arithmetic):
    """The kernel rule of an arithmetic, or None when it has none."""
    from ..decoder.arithmetic import (
        AminstarArithmetic,
        AminstarI8Arithmetic,
        MinstarApproxArithmetic,
        MinstarApproxI8Arithmetic,
        MinSumArithmetic,
        PhiArithmetic,
        TanhArithmetic,
    )

    if isinstance(arithmetic, MinSumArithmetic):
        return MinSumRule(arithmetic.storage_dtype, arithmetic.scale)
    for arith, rule in ((MinstarApproxI8Arithmetic, MinstarApproxI8Rule),
                        (AminstarI8Arithmetic, AminstarI8Rule)):
        if isinstance(arithmetic, arith):
            return rule(arithmetic.jones, arithmetic.hard_limit, arithmetic.deg1_clip)
    if isinstance(arithmetic, TanhArithmetic):
        return TanhRule(arithmetic.storage_dtype, arithmetic.clamp, arithmetic.prod_max)
    for arith, rule in ((PhiArithmetic, PhiRule),
                        (MinstarApproxArithmetic, MinstarApproxRule),
                        (AminstarArithmetic, AminstarRule)):
        if isinstance(arithmetic, arith):
            return rule(arithmetic.storage_dtype)
    return None


# -- the streaming flooding phases -------------------------------------------

#: the min-sum kernels' message storage types, by the code they take
#: (msg_bf16)
_MSG_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: threads per block of the check and variable phase kernels (a thread per
#: lane of a tile's 4 frames)
PHASE_THREADS = 256
#: threads per block of the f64 float rules' flooding kernels, resident and
#: phases, which give a thread one frame of a lane (``csrc/float_rules.cuh``
#: FloatRule's FloodUnits)
F64_UNIT_THREADS = 512
#: threads per block of the f32 float rules' flooding kernels, resident and
#: check phase, which give a check lane's thread a frame pair of a lane
#: (FloatRule's FloodUnits), and of their variable phase, which keeps a
#: lane's four frames a thread (FloatRule's VarUnits)
F32_UNIT_THREADS = 384
F32_VAR_THREADS = 256
#: threads per block of the i8 rules' flooding kernels, resident and
#: phases (``csrc/i8.cuh`` I8Rule's FloodUnits, whose block the check
#: phase's CheckUnits take: a lane's four frames a thread, 32 warps an SM)
I8_FLOODING_THREADS = 512
#: the layout tables the flooding kernels read, in their argument order
_TABLES = (
    "chk_cs", "chk_dest", "chk_rot", "chk_omask",
    "var_cs", "var_dest", "var_rot", "var_omask",
    "syn_vg", "syn_rot", "syn_mask",
)


@functools.cache
def flooding_lib():
    """The loaded library of ``csrc/flooding.cu`` (built at first use)."""
    return bind_flooding(_build.load("flooding"))


def bind_flooding(lib):
    """Declares the C interface of a library built from
    ``csrc/flooding.cu``; returns it."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i] * 6  # nbt, CG, VG, E, Z, Bt
    lib.ldpc_fused_check.argtypes = [p, p, p] + dims + [i, f, f, i, i, p]
    lib.ldpc_fused_var.argtypes = [p, p, p, p, p] + dims + [f, i, i, p]
    # bits, flags, frozen, conv, iters, count, it, scratch, tables, dims,
    # max degree, stream
    lib.ldpc_fused_syndrome.argtypes = [p] * 6 + [i, p, p] + dims + [i, p]
    # the resident decode takes the layered tables, a degree bucket and
    # the bytes of a stage of its ring
    lib.ldpc_resident_flooding_decode.argtypes = (
        [p] * 7 + [i] * 7 + [i, i, f, f, i, i, p]
    )
    lib.ldpc_ring_block_bytes.argtypes = [i]
    for fn in (
        lib.ldpc_fused_check, lib.ldpc_fused_var, lib.ldpc_fused_syndrome,
        lib.ldpc_resident_flooding_decode, lib.ldpc_ring_block_bytes,
    ):
        fn.restype = i
    lib.ldpc_flooding_error_string.argtypes = [i]
    lib.ldpc_flooding_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def flooding_i8_lib():
    """The loaded library of ``csrc/flooding_i8.cu``: the int8 instances of
    the resident flooding kernel and of the phases."""
    return bind_flooding_i8(_build.load("flooding_i8"))


def bind_flooding_i8(lib):
    """Declares the C interface of a library built from
    ``csrc/flooding_i8.cu``; returns it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    # pointers, nbt, CG, E, VG, Z, Bt, max degree, iterations, threads,
    # rule kind, flags, stream
    lib.ldpc_resident_flooding_i8_decode.argtypes = [p] * 7 + [i] * 11 + [p]
    lib.ldpc_resident_flooding_i8_decode.restype = i
    lib.ldpc_flooding_i8_error_string.argtypes = [i]
    lib.ldpc_flooding_i8_error_string.restype = ctypes.c_char_p
    # pointers, nbt, CG, VG, E, Z, Bt, (max degree,) threads, kind, flags,
    # stream
    lib.ldpc_fused_check_i8.argtypes = [p] * 3 + [i] * 10 + [p]
    lib.ldpc_fused_var_i8.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.ldpc_fused_check_i8.restype = lib.ldpc_fused_var_i8.restype = i
    lib.ldpc_i8_steps.argtypes = [p] * 3 + [i, p]
    lib.ldpc_i8_steps.restype = i
    return lib


#: the flooding sources of the float-rule instances, by storage type
FLOAT_FLOODING_SOURCES = {torch.float32: "flooding_f32", torch.float64: "flooding_f64"}


@functools.cache
def flooding_float_lib(name):
    """The loaded library of ``csrc/flooding_f32.cu`` or ``_f64.cu`` (by
    ``FLOAT_FLOODING_SOURCES``): the float-rule instances of the resident
    flooding kernel and of the phases."""
    return bind_flooding_float(_build.load(name))


def bind_flooding_float(lib):
    """Declares the C interface of a library built from
    ``csrc/flooding_f32.cu`` or ``_f64.cu``; returns it."""
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    # pointers, nbt, CG, E, VG, Z, Bt, max degree, iterations, threads,
    # rule kind, big, clamp, prod_max, stream
    lib.ldpc_resident_flooding_float_decode.argtypes = [p] * 7 + [i] * 10 + [d] * 3 + [p]
    lib.ldpc_resident_flooding_float_decode.restype = i
    lib.ldpc_flooding_float_error_string.argtypes = [i]
    lib.ldpc_flooding_float_error_string.restype = ctypes.c_char_p
    # pointers, nbt, CG, VG, E, Z, Bt, (max degree,) threads, kind, big,
    # clamp, prod_max, stream
    lib.ldpc_fused_check_float.argtypes = [p] * 3 + [i] * 9 + [d] * 3 + [p]
    lib.ldpc_fused_var_float.argtypes = [p] * 5 + [i] * 8 + [d] * 3 + [p]
    lib.ldpc_fused_check_float.restype = lib.ldpc_fused_var_float.restype = i
    return lib


def unit_threads(rule, lane_threads: int) -> int:
    """Threads per block of a float or i8 rule's flooding kernel, resident
    or check phase, whose block is ``lane_threads`` where a thread takes a
    lane's four frames: ``F64_UNIT_THREADS`` for an f64 rule,
    ``F32_UNIT_THREADS`` for an f32 one, ``I8_FLOODING_THREADS`` for an i8
    one."""
    if is_i8(rule):
        return I8_FLOODING_THREADS
    if rule.storage_dtype == torch.float32:
        return F32_UNIT_THREADS
    return F64_UNIT_THREADS if rule.storage_dtype == torch.float64 else lane_threads


def var_threads(rule, lane_threads: int) -> int:
    """Threads per block of a float or i8 rule's variable phase kernel
    (the rule's VarUnits): ``F32_VAR_THREADS`` for an f32 rule, else its
    ``unit_threads``."""
    if not is_i8(rule) and rule.storage_dtype == torch.float32:
        return F32_VAR_THREADS
    return unit_threads(rule, lane_threads)


def launch_args(x, layout, rule=None):
    """(table pointer array, tile dims, stream) of a flooding launch on the
    tiles ``x`` (nbt, P, Z, Bt); raises on what the kernels do not take: a
    tile width other than 4, and with a rule (the check and variable
    phases) a storage type the rule's kernels do not take and a check wider
    than the rule's cap (``check_degree_cap``)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    nbt, _, Z, Bt = x.shape
    if Z != layout.Z:
        raise ValueError(f"plane height {Z} does not match the layout's {layout.Z}")
    if not x.is_contiguous():
        raise ValueError("planes must be contiguous")
    if Bt != BT:
        raise ValueError(f"tile width {Bt}: the flooding kernels take {BT}")
    if rule is not None:
        if not takes_storage(rule):
            raise TypeError(f"unsupported message storage {rule.storage_dtype}")
        check_degree_cap(layout, rule)
    tables = [getattr(layout, name) for name in _TABLES]
    if any(
        t.device != x.device or t.dtype != torch.int32 or not t.is_contiguous()
        for t in tables
    ):
        raise TypeError("layout tables must be contiguous int32 on the planes' device")
    ptrs = (ctypes.c_void_p * len(tables))(*(t.data_ptr() for t in tables))
    dims = (nbt, layout.CG, layout.VG, layout.E, Z, Bt)
    return ptrs, dims, torch.cuda.current_stream(x.device).cuda_stream


def raise_on(err: int, name: str, error_string=None) -> None:
    """Raise if a launch's cudaError_t is not 0, with its text from
    ``error_string`` (a library's ``ldpc_*_error_string``; by default
    ``csrc/flooding.cu``'s)."""
    if err:
        text = (error_string or flooding_lib().ldpc_flooding_error_string)(err)
        raise RuntimeError(f"{name} launch failed: {text.decode()}")


def _check_planes(x, planes, layout, dtype, what):
    if x.ndim != 4 or x.shape[1] != planes or x.dtype != dtype:
        raise ValueError(
            f"{what} must be (nbt, {planes}, {layout.Z}, Bt) {dtype}, got "
            f"{tuple(x.shape)} {x.dtype}"
        )


def fused_check(v2c, layout, rule):
    """Check phase: v2c (nbt, E, Z, Bt) -> c2v (nbt, E, Z, Bt), both in the
    rule's storage type. ``layout``: a ``convert.DeviceLayout`` on the
    planes' device; ``rule``: any kernel rule (on a CUDA tensor an i8 rule
    goes to ``fused_check_i8``, a float rule to ``fused_check_float``)."""
    if v2c.device.type == "cpu":
        return fused_check_reference(v2c, layout, rule)
    if is_i8(rule):
        return fused_check_i8(v2c, layout, rule)
    if is_float_rule(rule):
        return fused_check_float(v2c, layout, rule)
    c2v, tables, dims, stream = _check_launch(v2c, layout, rule)
    raise_on(
        flooding_lib().ldpc_fused_check(
            v2c.data_ptr(), c2v.data_ptr(), tables, *dims,
            layout.max_chk_degree, rule.big, rule.scale,
            _MSG_DTYPES[rule.storage_dtype], PHASE_THREADS, stream,
        ),
        "fused_check",
    )
    fused_check.launches += 1
    return c2v


def _check_launch(v2c, layout, rule):
    """The checks of a check-phase launch; returns (c2v, tables, dims,
    stream)."""
    _check_planes(v2c, layout.E, layout, rule.storage_dtype, "v2c")
    tables, dims, stream = launch_args(v2c, layout, rule)
    return torch.empty_like(v2c), tables, dims, stream


def fused_check_i8(v2c, layout, rule):
    """``fused_check`` for an i8 rule, through the int8 instances of
    ``csrc/flooding_i8.cu``: int8 planes, int32 arithmetic, the rule's
    partial hard limit; check degree at most ``I8_MAX_CHECK_DEGREE``;
    ``I8_FLOODING_THREADS`` a block."""
    if v2c.device.type == "cpu":
        return fused_check_reference(v2c, layout, rule)
    if not is_i8(rule):
        raise TypeError(f"{type(rule).__name__} is not an i8 rule")
    c2v, tables, dims, stream = _check_launch(v2c, layout, rule)
    lib = flooding_i8_lib()
    raise_on(
        lib.ldpc_fused_check_i8(
            v2c.data_ptr(), c2v.data_ptr(), tables, *dims, layout.max_chk_degree,
            unit_threads(rule, PHASE_THREADS), rule.kind, rule.flags, stream,
        ),
        "fused_check_i8", lib.ldpc_flooding_i8_error_string,
    )
    fused_check_i8.launches += 1
    return c2v


def fused_check_float(v2c, layout, rule):
    """``fused_check`` for a float rule, through the float-rule instances of
    ``csrc/flooding_f32.cu`` or ``_f64.cu``: planes and arithmetic in the
    rule's storage type; check degree at most ``rule.max_check_degree``.
    The f64 instances give a thread one (lane, frame), the f32 ones a frame
    pair of a lane (``unit_threads``)."""
    if v2c.device.type == "cpu":
        return fused_check_reference(v2c, layout, rule)
    if not is_float_rule(rule):
        raise TypeError(f"{type(rule).__name__} is not a float rule")
    c2v, tables, dims, stream = _check_launch(v2c, layout, rule)
    lib = flooding_float_lib(FLOAT_FLOODING_SOURCES[rule.storage_dtype])
    raise_on(
        lib.ldpc_fused_check_float(
            v2c.data_ptr(), c2v.data_ptr(), tables, *dims, layout.max_chk_degree,
            unit_threads(rule, PHASE_THREADS), rule.kind, rule.big, rule.clamp,
            rule.prod_max, stream,
        ),
        "fused_check_float", lib.ldpc_flooding_float_error_string,
    )
    fused_check_float.launches += 1
    return c2v


def fused_var(c2v, q, layout, rule):
    """Variable phase: c2v (nbt, E, Z, Bt) and the channel planes q (nbt,
    VG, Z, Bt), both in the rule's storage type -> (v2c (nbt, E, Z, Bt),
    bits (nbt, VG, Z, Bt) int8). ``c2v=None`` is the initialisation: every
    v2c output is q, rolled, with big at the missing lanes (no rule clips).
    On a CUDA tensor an i8 rule goes to ``fused_var_i8``, a float rule to
    ``fused_var_float``."""
    if q.device.type == "cpu":
        return fused_var_reference(c2v, q, layout, rule)
    if is_i8(rule):
        return fused_var_i8(c2v, q, layout, rule)
    if is_float_rule(rule):
        return fused_var_float(c2v, q, layout, rule)
    v2c, bits, tables, dims, stream = _var_launch(c2v, q, layout, rule)
    raise_on(
        flooding_lib().ldpc_fused_var(
            None if c2v is None else c2v.data_ptr(), q.data_ptr(),
            v2c.data_ptr(), bits.data_ptr(), tables, *dims, rule.big,
            _MSG_DTYPES[rule.storage_dtype], PHASE_THREADS, stream,
        ),
        "fused_var",
    )
    fused_var.launches += 1
    return v2c, bits


def _var_launch(c2v, q, layout, rule):
    """The checks of a variable-phase launch; returns (v2c, bits, tables,
    dims, stream)."""
    _check_planes(q, layout.VG, layout, rule.storage_dtype, "q")
    if c2v is not None:
        _check_planes(c2v, layout.E, layout, rule.storage_dtype, "c2v")
        if c2v.shape[0] != q.shape[0] or c2v.shape[3] != q.shape[3]:
            raise ValueError("c2v and q tiles differ")
        if not c2v.is_contiguous() or c2v.device != q.device:
            raise ValueError("c2v must be contiguous on q's device")
    tables, dims, stream = launch_args(q, layout, rule)
    nbt, VG, Z, Bt = q.shape
    v2c = torch.empty((nbt, layout.E, Z, Bt), dtype=q.dtype, device=q.device)
    bits = torch.empty((nbt, VG, Z, Bt), dtype=torch.int8, device=q.device)
    return v2c, bits, tables, dims, stream


def fused_var_i8(c2v, q, layout, rule):
    """``fused_var`` for an i8 rule, through the int8 instances of
    ``csrc/flooding_i8.cu``: int8 planes, int32 arithmetic, the rule's
    Jones clip and Deg1Clip (none in the initialisation);
    ``I8_FLOODING_THREADS`` a block."""
    if q.device.type == "cpu":
        return fused_var_reference(c2v, q, layout, rule)
    if not is_i8(rule):
        raise TypeError(f"{type(rule).__name__} is not an i8 rule")
    v2c, bits, tables, dims, stream = _var_launch(c2v, q, layout, rule)
    lib = flooding_i8_lib()
    raise_on(
        lib.ldpc_fused_var_i8(
            None if c2v is None else c2v.data_ptr(), q.data_ptr(), v2c.data_ptr(),
            bits.data_ptr(), tables, *dims, unit_threads(rule, PHASE_THREADS), rule.kind,
            rule.flags, stream,
        ),
        "fused_var_i8", lib.ldpc_flooding_i8_error_string,
    )
    fused_var_i8.launches += 1
    return v2c, bits


def fused_var_float(c2v, q, layout, rule):
    """``fused_var`` for a float rule, through the float-rule instances of
    ``csrc/flooding_f32.cu`` or ``_f64.cu``: planes and arithmetic in the
    rule's storage type; ``var_threads`` a block."""
    if q.device.type == "cpu":
        return fused_var_reference(c2v, q, layout, rule)
    if not is_float_rule(rule):
        raise TypeError(f"{type(rule).__name__} is not a float rule")
    v2c, bits, tables, dims, stream = _var_launch(c2v, q, layout, rule)
    lib = flooding_float_lib(FLOAT_FLOODING_SOURCES[rule.storage_dtype])
    raise_on(
        lib.ldpc_fused_var_float(
            None if c2v is None else c2v.data_ptr(), q.data_ptr(), v2c.data_ptr(),
            bits.data_ptr(), tables, *dims, var_threads(rule, PHASE_THREADS), rule.kind,
            rule.big, rule.clamp, rule.prod_max, stream,
        ),
        "fused_var_float", lib.ldpc_flooding_float_error_string,
    )
    fused_var_float.launches += 1
    return v2c, bits


def fused_syndrome_bits(bits, layout):
    """Syndrome of hard-decision planes: bits (nbt, VG, Z, Bt) int8 ->
    flags (nbt, Bt) int32, 1 where the frame has an unsatisfied check."""
    if bits.device.type == "cpu":
        return fused_syndrome_bits_reference(bits, layout)
    _check_planes(bits, layout.VG, layout, torch.int8, "bits")
    tables, dims, stream = launch_args(bits, layout)
    nbt, _, _, Bt = bits.shape
    flags = torch.empty((nbt, Bt), dtype=torch.int32, device=bits.device)
    raise_on(
        flooding_lib().ldpc_fused_syndrome(
            bits.data_ptr(), flags.data_ptr(), None, None, None, None, 0,
            _syndrome_scratch(bits.device, stream, nbt).data_ptr(), tables, *dims,
            layout.max_chk_degree, stream,
        ),
        "fused_syndrome_bits",
    )
    fused_syndrome_bits.launches += 1
    return flags


def fused_syndrome_freeze(bits, frozen, conv, iters, it, counter, layout):
    """The streaming loop's test of iteration ``it`` and the freeze of the
    frames that pass, in place. bits and frozen (t, VG, Z, Bt) int8, conv
    (t * Bt,) bool, iters (t * Bt,) int32 (frame = tile * Bt + lane),
    counter a one-element int32 tensor. A frame whose bits satisfy every
    check and whose conv is 0 gets iters = it and its bytes of bits copied
    to frozen; conv |= the frames that pass; counter = the frames with conv
    0 after it. One launch of the syndrome kernel on a CUDA tensor; on a
    CPU tensor the plain version."""
    if bits.device.type == "cpu":
        return fused_syndrome_freeze_reference(bits, frozen, conv, iters, it, counter, layout)
    _check_planes(bits, layout.VG, layout, torch.int8, "bits")
    nbt, _, _, Bt = bits.shape
    if frozen.shape != bits.shape or frozen.dtype != torch.int8:
        raise ValueError(f"frozen must be {tuple(bits.shape)} int8")
    for x, dtype, what in ((conv, torch.bool, "conv"), (iters, torch.int32, "iters")):
        if x.shape != (nbt * Bt,) or x.dtype != dtype:
            raise ValueError(f"{what} must be ({nbt * Bt},) {dtype}")
    if counter.numel() != 1 or counter.dtype != torch.int32:
        raise ValueError("counter must be one int32")
    tensors = (bits, frozen, conv, iters, counter)
    if any(x.device != bits.device or not x.is_contiguous() for x in tensors):
        raise ValueError("the tensors must be contiguous on one device")
    tables, dims, stream = launch_args(bits, layout)
    raise_on(
        flooding_lib().ldpc_fused_syndrome(
            bits.data_ptr(), None, frozen.data_ptr(), conv.data_ptr(), iters.data_ptr(),
            counter.data_ptr(), it, _syndrome_scratch(bits.device, stream, nbt).data_ptr(),
            tables, *dims, layout.max_chk_degree, stream,
        ),
        "fused_syndrome_freeze",
    )
    fused_syndrome_freeze.launches += 1


#: the syndrome kernel's scratch by (device, stream handle): int32, zero
#: between launches (the kernel leaves it so); a launch uses it until it
#: ends, so launches on one stream, which run in turn, share one, and those
#: on two streams, which may overlap, do not
_SCRATCH = {}


def _syndrome_scratch(device, stream, nbt):
    """The syndrome kernel's scratch on ``device`` for launches on the
    stream ``stream`` (its handle) over nbt tiles: ``nbt * 2 + 2`` int32,
    zero, grown when a launch needs more (allocated on that stream)."""
    scratch = _SCRATCH.get((device, stream))
    if scratch is None or scratch.numel() < 2 * nbt + 2:
        scratch = torch.zeros(2 * nbt + 2, dtype=torch.int32, device=device)
        _SCRATCH[device, stream] = scratch
    return scratch


#: the i8 rules' word steps of ``csrc/i8.cuh``, in the order ``i8_steps``
#: gives them
I8_STEPS = ("tab4", "minstar_approx4", "minstar_full4", "phl4")


def i8_steps(a, b):
    """The i8 rules' word steps (``csrc/i8.cuh``) on words of four frames:
    a and b (n,) int32, a byte in [0, 127] a frame -> (4, n) int32, the
    words of tab4(a), minstar_approx4(a, b), minstar_full4(a, b) and
    phl4(a) (``I8_STEPS``). On a CUDA tensor it launches
    ``i8_steps_kernel`` of ``csrc/flooding_i8.cu``; on a CPU tensor its
    plain version, the rules' functions of one frame on each byte."""
    if a.shape != b.shape or a.ndim != 1 or a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError("a and b must be (n,) int32")
    if a.device.type == "cpu":
        return i8_steps_reference(a, b)
    if b.device != a.device or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous on one device")
    out = torch.empty((len(I8_STEPS), a.numel()), dtype=torch.int32, device=a.device)
    lib = flooding_i8_lib()
    raise_on(lib.ldpc_i8_steps(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                               torch.cuda.current_stream(a.device).cuda_stream),
             "i8_steps", lib.ldpc_flooding_i8_error_string)
    i8_steps.launches += 1
    return out


def i8_steps_reference(a, b):
    """``i8_steps``' plain version: each byte through the rules' functions
    of one frame (``MinstarApproxI8Rule._tab`` and ``_fold``,
    ``AminstarI8Rule._minstar_full``, ``_phl``)."""
    approx, full = MinstarApproxI8Rule(), AminstarI8Rule()
    steps = (lambda x, y: approx._tab(x), approx._fold, full._minstar_full,
             lambda x, y: _phl(x))
    out = torch.zeros((len(I8_STEPS), a.numel()), dtype=torch.int32, device=a.device)
    for f in range(BT):
        x, y = (a >> 8 * f) & 0xFF, (b >> 8 * f) & 0xFF
        for s, step in enumerate(steps):
            out[s] |= (step(x, y) & 0xFF) << 8 * f
    return out


#: kernel launches since the count was last set to 0 (the min-sum
#: instances; the int8 and float-rule instances count on their wrappers)
fused_check.launches = 0
fused_check_i8.launches = 0
fused_check_float.launches = 0
fused_var.launches = 0
fused_var_i8.launches = 0
fused_var_float.launches = 0
fused_syndrome_bits.launches = 0
fused_syndrome_freeze.launches = 0
i8_steps.launches = 0


def _roll_planes(x, rot):
    """x (nbt, P, Z, Bt), rot (P,) -> out[:, p, i] = x[:, p, (i - rot[p])
    mod Z]."""
    nbt, P, Z, Bt = x.shape
    lane = torch.arange(Z, device=x.device)
    src = (lane[None, :] - rot.to(x.device, torch.long)[:, None]) % Z
    return torch.gather(x, 2, src[None, :, :, None].expand(nbt, P, Z, Bt))


def _poke(x, mask, value):
    """Lane ``mask[p]`` of plane p set to value (-1: none)."""
    lane = torch.arange(x.shape[2], device=x.device)
    hit = lane[None, :] == mask.to(x.device, torch.long)[:, None]
    return torch.where(hit[None, :, :, None], value, x)


def fused_check_reference(v2c, layout, rule):
    """The plain PyTorch version of ``fused_check``, on any device, in the
    rule's compute type."""
    nbt, E, Z, Bt = v2c.shape
    c2v = torch.empty_like(v2c)
    for m in layout.chk_meta:
        if not m.d:
            continue
        G = m.g1 - m.g0
        e0, e1 = m.ebase, m.ebase + G * m.d
        x = v2c[:, e0:e1].to(rule.compute_dtype).reshape(nbt, G, m.d, Z, Bt)
        outs = rule.check([x[:, :, t] for t in range(m.d)])  # (d, nbt, G, ...)
        o = outs.permute(1, 2, 0, 3, 4).reshape(nbt, G * m.d, Z, Bt)
        o = _poke(_roll_planes(o, layout.chk_rot[e0:e1]), layout.chk_omask[e0:e1], 0)
        c2v[:, layout.chk_dest[e0:e1].long()] = o.to(v2c.dtype)
    return c2v


def fused_var_reference(c2v, q, layout, rule):
    """The plain PyTorch version of ``fused_var``, on any device, in the
    rule's compute type."""
    nbt, VG, Z, Bt = q.shape
    v2c = torch.empty((nbt, layout.E, Z, Bt), dtype=q.dtype, device=q.device)
    bits = torch.empty((nbt, VG, Z, Bt), dtype=torch.int8, device=q.device)
    for m in layout.var_meta:
        G = m.g1 - m.g0
        e0, e1 = m.ebase, m.ebase + G * m.d
        qf = q[:, m.g0 : m.g1].to(rule.compute_dtype)
        if c2v is None:
            outs, tot = [qf] * m.d, qf
        else:
            y = c2v[:, e0:e1].to(rule.compute_dtype).reshape(nbt, G, m.d, Z, Bt)
            outs, tot = rule.var(qf, [y[:, :, t] for t in range(m.d)], m.d)
        bits[:, m.g0 : m.g1] = (tot <= 0).to(torch.int8)
        if not m.d:
            continue
        o = torch.stack(outs, dim=2).reshape(nbt, G * m.d, Z, Bt)
        o = _roll_planes(o, layout.var_rot[e0:e1])
        o = _poke(o, layout.var_omask[e0:e1], rule.big)
        v2c[:, layout.var_dest[e0:e1].long()] = o.to(q.dtype)
    return v2c, bits


def fused_syndrome_bits_reference(bits, layout):
    """The plain PyTorch version of ``fused_syndrome_bits``, on any
    device."""
    nbt, VG, Z, Bt = bits.shape
    bad = torch.zeros((nbt, Bt), dtype=torch.bool, device=bits.device)
    for m in layout.chk_meta:
        if not m.d:
            continue
        G = m.g1 - m.g0
        e0, e1 = m.ebase, m.ebase + G * m.d
        b = bits[:, layout.syn_vg[e0:e1].long()].to(torch.int32) & 1
        b = _poke(_roll_planes(b, layout.syn_rot[e0:e1]), layout.syn_mask[e0:e1], 0)
        par = b.reshape(nbt, G, m.d, Z, Bt).sum(dim=2) & 1
        bad |= par.flatten(1, 2).any(dim=1)
    return bad.to(torch.int32)


def fused_syndrome_freeze_reference(bits, frozen, conv, iters, it, counter, layout):
    """The plain PyTorch version of ``fused_syndrome_freeze``, on any
    device: the streaming loop's torch ops."""
    freeze_on_flags(fused_syndrome_bits_reference(bits, layout), bits, frozen, conv, iters,
                    it, counter)


def freeze_on_flags(flags, bits, frozen, conv, iters, it, counter):
    """The freeze of ``fused_syndrome_freeze_reference`` on the (t, Bt)
    flags of ``bits`` (nonzero where a frame has an unsatisfied check), in
    place."""
    ok = flags.reshape(-1) == 0
    newly = ok & ~conv
    iters.copy_(torch.where(newly, it, iters))
    frozen.copy_(torch.where(newly.reshape(-1, 1, 1, bits.shape[-1]), bits, frozen))
    conv |= ok
    counter.copy_((~conv).sum())
