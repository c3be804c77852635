"""Exactness smoke test on a device: the kernel route against the plane path.

Counterpart of ``ldpc_toolbox_tpu.selftest``. For each rule family it
decodes one small batch on the given device twice: through the kernels,
resident, as ``Decoder`` routes the name (``kernel_flooding_decode``,
``kernel_layered_decode``), and through the independent torch path of the
same schedule (``plane_flooding_decode``, the plane-gather flooding path;
``plain_layered_decode``, the layered jnp path's twin). It demands equal
success flags and iteration counts, and equal codewords: all of them under
the i8 rules, which do not round, and the frames both sides decoded under
the float rules, whose unconverged posteriors may round apart. A family
whose plane path converges on no frame fails too. On a CUDA device this
is a check of the hand-written kernels against code that shares none of
their glue; on the CPU both sides are torch ops.

The ``selftest`` subcommand of the command line runs it (``--families``,
``--max-iter``, ``--device``).
"""

from __future__ import annotations

import numpy as np
import torch

from .codes.ccsds import C2Code
from .codes.dvbs2 import Code
from .decoder import lifted_flooding, lifted_layered
from .decoder.factory import make_arithmetic
from .decoder.lifted import lifted_graph_for
from .encoder import Encoder

__all__ = ["SELFTEST_FAMILIES", "run_selftest"]

#: one name a kernel rule family (the seven check-rule kinds), the layered
#: schedule for the flagship arithmetic and an i8 family, and the f32
#: min-sum names of the compressed kernels. The ``c2:`` entries run both
#: schedules again on CCSDS C2, whose Z = 511 is the only standards lift
#: that is not a multiple of 8. ``aliased:`` named the JAX package's
#: single-array flooding kernel, which it forced in place of its two-array
#: form; the port's resident flooding kernel has only that form (one
#: aliased message array), so the prefix routes as the bare name does.
SELFTEST_FAMILIES = [
    "Minsumbf16",
    "Phif32",
    "Tanhf32",
    "Minstarapproxf32",
    "Aminstarf32",
    "Minstarapproxi8",
    "Aminstari8",
    "HLMinsumbf16",
    "HLMinstarapproxi8",
    "c2:Minsumbf16",
    "c2:HLMinsumbf16",
    "aliased:Minsumbf16",
    "Minsumf32",
    "HLMinsumf32",
]


def _workload(batch: int):
    """DVB-S2 R1_4short, whose staircase corner is the one incomplete
    circulant of the standards codes, and the LLRs of noisy codewords at
    its waterfall (sigma 0.85, seed 2): (LiftedGraph, (batch, n) float32
    numpy LLRs)."""
    code = Code.R1_4short
    enc = Encoder(code.h(), device="cpu")
    rng = np.random.default_rng(2)
    msgs = rng.integers(0, 2, size=(batch, enc.k))
    cw = enc.encode_batch(torch.from_numpy(msgs)).numpy()
    sigma = 0.85
    x = np.where(cw == 0, -1.0, 1.0) + sigma * rng.standard_normal(cw.shape)
    return lifted_graph_for(code), ((-2.0 / sigma**2) * x).astype(np.float32)


def _workload_c2(batch: int):
    """CCSDS C2 (8176, 7156), the all-zero codeword at its waterfall
    (sigma 0.45, seed 3)."""
    rng = np.random.default_rng(3)
    sigma = 0.45
    x = -1.0 + sigma * rng.standard_normal((batch, 8176))
    return lifted_graph_for(C2Code()), ((-2.0 / sigma**2) * x).astype(np.float32)


def run_selftest(families=None, batch: int = 128, iterations: int = 8, log=None,
                 device="cuda") -> list[str]:
    """Run the kernel-against-plane comparison of each family on
    ``device``; returns the names that failed. ``log(name, ok, detail)`` is
    called for each family when given. A name whose kernels do not take
    its workload raises: nothing falls back here."""
    workloads = {}

    def workload_for(key):
        if key not in workloads:
            lg, llr = (_workload_c2 if key == "c2" else _workload)(batch)
            workloads[key] = (lg, torch.from_numpy(llr).to(device))
        return workloads[key]

    failures = []
    for name in families or SELFTEST_FAMILIES:
        key, _, decoder = name.rpartition(":")
        lg, llr = workload_for("c2" if key == "c2" else "dvbs2")
        schedule, arith = make_arithmetic(decoder)
        reason = lifted_layered.kernel_fallback(lg, arith)
        if reason is not None:
            raise ValueError(f"{name}: the kernels do not take it ({reason})")
        if schedule == "layered":
            kernel = lifted_layered.kernel_layered_decode(lg, arith, llr, iterations)
            plane = lifted_layered.plain_layered_decode(lg, arith, llr, iterations)
        else:
            kernel = lifted_flooding.kernel_flooding_decode(lg, arith, llr, iterations)
            plane = lifted_flooding.plane_flooding_decode(lg, arith, llr, iterations)
        sk = kernel["success"].cpu().numpy()
        sp = plane["success"].cpu().numpy()
        cw_k = kernel["codeword"].cpu().numpy()
        cw_p = plane["codeword"].cpu().numpy()
        scope = slice(None) if arith.is_int8 else sk & sp
        same = (
            bool((sk == sp).all())
            and bool((kernel["iterations"].cpu() == plane["iterations"].cpu()).all())
            and bool((cw_k[scope] == cw_p[scope]).all())
        )
        if log is not None:
            log(name, same, f"converged {int(sk.sum())}/{batch}, "
                            f"success match {int((sk == sp).sum())}/{batch}")
        if not same or not int(sp.sum()):
            failures.append(name)
    return failures
