"""Flat decode layout and per-plane check rules.

Counterpart of ``ldpc_toolbox_tpu.ops.fused_bp2``. The layout is numpy and
built once per code; the rules are plain functions on torch tensors, the
plain versions of what the CUDA kernels inline.

Every message plane is stored once, in its consumer's lane coordinates
and in consumer-major order: check-major ``(E, Z, B)`` planes for the
check side, var-major for the variable side. Moving a plane between the
two sides is a roll by the edge's lift shift. Incomplete circulants (the
DVB-S2 staircase corner) have one missing lane per affected edge: a check
update sees ``big`` there (min-sum ignores it) and emits 0 there.

Still to be ported from the JAX module: the streaming phase kernels
``fused_check`` and ``fused_var``, the syndrome kernel
``fused_syndrome_bits``, and the rules of the Phi, Tanh, Minstarapprox,
Aminstar and i8 families (ROADMAP queues A and B).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "FusedLayout",
    "build_fused_layout",
    "MinSumRule",
    "rule_for",
]


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


class MinSumRule:
    """(Normalized) min-sum over float planes: the min1/min2/argmin/
    sign-parity fold that ``csrc/resident_layered.cu`` inlines, in the
    same order and with the same rounding points."""

    def __init__(self, dtype, scale: float = 1.0):
        self.storage_dtype = dtype
        # missing-lane poke and initial second minimum
        self.big = float(torch.finfo(dtype).max)
        self.scale = float(scale)

    def check(self, planes) -> torch.Tensor:
        """d planes (a list, or a tensor with the d planes on dim 0) of
        f32 extrinsics -> the (d, ...) stacked f32 check outputs."""
        d = len(planes)
        mags = [x.abs() for x in planes]
        negs = [x < 0 for x in planes]
        m1 = mags[0]
        m2 = torch.full_like(m1, self.big)
        arg = torch.zeros(m1.shape, dtype=torch.int32, device=m1.device)
        par = negs[0]
        for k in range(1, d):
            mk = mags[k]
            m2 = torch.minimum(m2, torch.maximum(m1, mk))
            take = mk < m1
            m1 = torch.where(take, mk, m1)
            arg = torch.where(take, k, arg)
            par = par ^ negs[k]
        outs = []
        for t in range(d):
            loo = torch.where(arg == t, m2, m1)
            if self.scale != 1.0:
                loo = loo * self.scale
            outs.append(torch.where(par ^ negs[t], -loo, loo))
        return torch.stack(outs)

    # layered-schedule helper (horizontal_layered.rs:105-110)
    def layered_x(self, qv, rold):
        return qv - rold


def rule_for(arithmetic):
    """The kernel rule of an arithmetic, or None when it has none yet."""
    from ..decoder.arithmetic import MinSumArithmetic

    if isinstance(arithmetic, MinSumArithmetic):
        return MinSumRule(arithmetic.storage_dtype, arithmetic.scale)
    return None
