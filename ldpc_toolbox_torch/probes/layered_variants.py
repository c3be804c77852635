"""P5: where a layered sweep's time goes, the sweep with parts removed.

Ports ``tools/prof_layered_variants.py`` of the JAX package (``make_iteration``:
stripped-down copies of the TPU's streaming layered sweep,
``ops/fused_layered.py fused_layered_iteration``, timed over chained
sweeps). ``layered_sweep_parts`` runs ``full`` through
``ops.fused_layered.fused_layered_iteration`` itself and launches
``fused_layered_parts_kernel`` of ``csrc/probe_layered.cu`` for the others:
the body of the port's own sweep (``csrc/streaming.cuh``
``LDPC_FUSED_LAYERED_BODY``) with one part taken away. In place on qv (nbt, VG,
Z, 4) f32 and rcv (nbt, E, Z, 4) in the rule's storage type, under a
min-sum rule; each variant also writes the hard bits qv <= 0:

- ``full``: the whole sweep (``fused_layered_iteration``, which counts its
  own launches);
- ``normw``: no Qv update (every group reads the sweep-entry Qv; Rcv is
  still written);
- ``noroll``: no rotations (check lane c reads and updates variable lane
  c);
- ``norule``: the rule is the identity (each output is its input x, 0 at
  the missing lane);
- ``dmaonly``: Rcv read and written back, nothing computed, Qv as it was.

    python -m ldpc_toolbox_torch.probes.layered_variants

prints each variant's ms a sweep (a median over ``K`` chained sweeps,
``_kernels.chain_ms``) on DVB-S2 R1_2 under ``HLMinsumbf16`` at B = 512,
the tool's case.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.dvbs2 import Code
from ..decoder.factory import make_arithmetic
from ..decoder.lifted import lifted_graph_for
from ..decoder.lifted_layered import device_layout
from ..ops.fused_bp2 import _MSG_DTYPES, MinSumRule, rule_for
from ..ops.fused_layered import _sweep_args, fused_layered_iteration
from ..ops.resident_layered import plane_tables
from . import _kernels

__all__ = ["VARIANTS", "layered_sweep_parts", "layered_sweep_parts_reference", "main"]

#: the tool's case: code, name, frames and chained sweeps
CODE, NAME, BATCH, K = "R1_2", "HLMinsumbf16", 512, 30
#: the variants, by their lanes.cuh SweepParts (0, the whole sweep, is
#: ``fused_layered_iteration``)
VARIANTS = {"full": 0, "normw": 1, "noroll": 2, "norule": 3, "dmaonly": 4}
#: the largest check degree the probe's instances take (buckets 8 and 16)
MAX_DEGREE = 16


def layered_sweep_parts(qv_t, rcv_t, layout, rule, variant: str):
    """One layered sweep of ``variant`` (see the module) in place on qv_t
    and rcv_t; returns (qv_t, rcv_t, bits (nbt, VG, Z, 4) int8). A min-sum
    rule, check degree at most 16. On a CUDA tensor it launches the
    kernel (``full``: ``fused_layered_iteration``), on a CPU tensor it runs
    the plain version."""
    if qv_t.device.type == "cpu":
        return layered_sweep_parts_reference(qv_t, rcv_t, layout, rule, variant)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}")
    if not isinstance(rule, MinSumRule):
        raise TypeError("the probe takes a min-sum rule")
    if layout.max_chk_degree > MAX_DEGREE:
        raise ValueError(f"the probe takes check degrees up to {MAX_DEGREE}")
    if variant == "full":
        return fused_layered_iteration(qv_t, rcv_t, layout, rule)
    bits, head, stream = _sweep_args(qv_t, rcv_t, layout, rule)
    lib = _kernels.layered_lib()
    err = lib.ldpc_probe_layered_sweep(*head, rule.big, rule.scale,
                                       _MSG_DTYPES[rule.storage_dtype], VARIANTS[variant],
                                       stream)
    _kernels.raise_on(lib, err, "layered_sweep_parts")
    layered_sweep_parts.launches += 1
    return qv_t, rcv_t, bits


#: kernel launches since the count was last set to 0
layered_sweep_parts.launches = 0


def layered_sweep_parts_reference(qv_t, rcv_t, layout, rule, variant: str):
    """The plain PyTorch version of ``layered_sweep_parts`` (any device,
    in place): ``ops.resident_layered.message_sweep`` with the part taken
    away."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}")
    nbt, VG, Z, Bt = qv_t.shape
    if variant != "dmaonly":
        def untile(x):  # a copy, written back below
            return x.permute(1, 2, 0, 3).clone(memory_format=torch.contiguous_format)

        qv = untile(qv_t).reshape(VG * Z, nbt * Bt)
        rcv = untile(rcv_t).reshape(layout.E, Z, nbt * Bt)
        src, valid, groups = plane_tables(layout, qv_t.device)
        if variant == "noroll":
            src = layout.syn_vg.to(qv_t.device, torch.long)[:, None] * Z + torch.arange(
                Z, device=qv_t.device)
        for _, e0, d in groups:
            idx = src[e0 : e0 + d]
            ok_lane = valid[e0 : e0 + d]
            rold = rcv[e0 : e0 + d].to(rule.compute_dtype)
            x = torch.where(ok_lane, rule.layered_x(qv[idx], rold), rule.big)
            rn = torch.where(ok_lane, x if variant == "norule" else rule.check(x), 0)
            delta = rn - rold
            rcv[e0 : e0 + d] = rn.to(rule.storage_dtype)
            if variant != "normw":
                for t in range(d):
                    qv[idx[t]] += delta[t].to(qv.dtype)
        qv_t.copy_(qv.reshape(VG, Z, nbt, Bt).permute(2, 0, 1, 3))
        rcv_t.copy_(rcv.reshape(layout.E, Z, nbt, Bt).permute(2, 0, 1, 3))
    return qv_t, rcv_t, (qv_t <= 0).to(torch.int8)


def case(batch: int = BATCH, seed: int = 0, device="cuda"):
    """The tool's case at ``batch`` frames: (layout, rule, qv0, rcv0), qv0
    standard normal f32 tiles, rcv0 zero."""
    layout = device_layout(lifted_graph_for(Code[CODE]), device)
    rule = rule_for(make_arithmetic(NAME)[1])
    rng = np.random.default_rng(seed)
    qv0 = rng.standard_normal((batch // 4, layout.VG, layout.Z, 4), dtype=np.float32)
    rcv0 = torch.zeros((batch // 4, layout.E, layout.Z, 4), dtype=rule.storage_dtype,
                       device=device)
    return layout, rule, torch.from_numpy(qv0).to(device), rcv0


def sweeps_ms(layout, rule, qv0, rcv0, variant, sweeps: int = K) -> _kernels.Chain:
    """One sweep of ``variant`` timed by ``_kernels.chain_ms`` over
    ``sweeps`` chained sweeps in place from (qv0, rcv0) (after its
    warm-ups, which sweep on the same planes)."""
    qv, rcv = qv0.clone(), rcv0.clone()
    return _kernels.chain_ms(lambda: layered_sweep_parts(qv, rcv, layout, rule, variant), sweeps)


def main():
    print(_kernels.card_line())
    layout, rule, qv0, rcv0 = case()
    for variant in VARIANTS:
        t = sweeps_ms(layout, rule, qv0, rcv0, variant)
        print(f"{variant:8s}: {t.ms:6.3f} ms/iter", flush=True)


if __name__ == "__main__":
    main()
