"""P2: the elementwise rate, R x K chained rounds of one op over planes.

Ports ``tools/prof_vpu_peak.py`` of the JAX package (``make``: a (360, 128)
f32 plane held in the TPU's vector memory through R grid steps of K
unrolled rounds). ``alu_chain`` launches ``alu_chain_kernel`` (add, fma,
sel) or ``roll_chain_kernel<Z, T>`` (roll) of ``csrc/probes.cu``: a
thread's element chained in a register; for roll a column in the registers
of T lanes of a warp (``ROLL_LANES``), the rotation a renaming of registers
inside a lane and a warp shuffle across lanes (``roll_source``). One plane
fills about 22 of the card's 132 SMs, so ``main`` runs ``PLANES``
independent planes; the function of each plane is the tool's.

A round is, for x f32:

- ``add``: x + 1.0000001
- ``fma``: x * 1.0000001 + 1e-7 (the kernel's fmaf rounds once, the plain
  version's multiply and add twice; from the tool's inputs in [0.4, 0.6)
  both add 5 ulp a round below 0.5 and 3 ulp above, so they agree bit for
  bit through the tool's 32768 rounds (the values stay below 0.61), where
  a round without the multiply adds 3 and 2 ulp and one without the add
  2 and 1)
- ``sel``: x + 1.0000001 where x > 0.5, else x - 0.9999999
- ``roll``: roll(x, 37, axis 0) + 1.0000001

    python -m ldpc_toolbox_torch.probes.vpu_peak

prints each op's time and operations/s (the tool's count: add and fma 1
an element a round, sel 4, roll 2) beside the issue rate of the card's
SMs, 33.5e12 instructions/s (computed: 132 SMs x 4 sub-partitions x 32
lanes x 1.98 GHz), and the data sheet's 67e12 f32 FLOP/s.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

__all__ = ["ISSUE_RATE", "MODES", "OPS", "PLANES", "ROLL_LANES", "alu_chain",
           "alu_chain_reference", "main", "roll_source"]

#: the tool's plane, rounds unrolled a grid step and grid steps
Z, B, K, R = 360, 128, 128, 256
#: operations an element a round, as the tool counts them
OPS = {"add": 1, "fma": 1, "sel": 4, "roll": 2}
MODES = tuple(OPS)
#: planes ``main`` runs at once: a few waves of the card's SMs
PLANES = 132
#: thread instructions the H100 SXM issues a second (computed): 132 SMs,
#: 4 sub-partitions each issuing one instruction of 32 lanes a clock, at
#: the 1.98 GHz boost clock
ISSUE_RATE = 132 * 4 * 32 * 1.98e9
#: FP32-pipe instructions the H100 SXM runs a second (computed): 132 SMs x
#: 128 FP32 lanes at 1.98 GHz, the same number as ``ISSUE_RATE``
FP32_PIPE_RATE = 132 * 128 * 1.98e9
#: P2's bound (``chip_smoke.py``), a round's least instructions, counted
#: from the SASS of ``alu_chain_kernel<OP>``: its f32 instructions (opcodes
#: F...) over the opcode it runs once a round, given here; those of
#: ``FP32_PIPE_OPCODES`` go to the FP32 pipe. roll is charged add's
#: count: nothing for moving a value to its new row, a bound that no
#: layout reaches
ROUND_MARKS = {"add": "FADD", "fma": "FFMA", "sel": "FSETP"}
FP32_PIPE_OPCODES = ("FADD", "FFMA", "FMUL")
#: the data sheet's f32 rate outside the tensor cores (an FMA two FLOP)
F32_FLOPS = 67e12
_ROLL = 37
#: the Z values roll's kernel is built for (the tool's and the tests'),
#: each with its lanes a column, T (``csrc/probes.cu`` ``ldpc_probe_alu_chain``)
ROLL_LANES = {24: 4, 40: 4, 360: 2}


def alu_chain(x: torch.Tensor, mode: str, rounds: int = R * K) -> torch.Tensor:
    """``rounds`` chained rounds of ``mode`` on (planes, Z, B) f32, a new
    tensor. On a CUDA tensor it launches the kernel (roll: Z one of
    ``ROLL_LANES``), on a CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return alu_chain_reference(x, mode, rounds)
    if mode not in OPS:
        raise ValueError(f"mode must be one of {MODES}")
    if x.dim() != 3 or x.dtype != torch.float32:
        raise TypeError("x must be (planes, Z, B) f32")
    if mode == "roll" and x.shape[1] not in ROLL_LANES:
        raise ValueError(f"roll's kernel is built for Z in {sorted(ROLL_LANES)}, not {x.shape[1]}")
    if x.shape[0] * x.shape[2] >= 2**31:
        raise ValueError("alu_chain takes fewer than 2**31 columns")
    out = torch.empty_like(x)
    stream = _kernels.on_card("alu_chain", x, out)
    lib = _kernels.lib()
    err = lib.ldpc_probe_alu_chain(x.data_ptr(), out.data_ptr(), *x.shape, MODES.index(mode),
                                   rounds, stream)
    _kernels.raise_on(lib, err, "alu_chain")
    alu_chain.launches += 1
    return out


#: kernel launches since the count was last set to 0
alu_chain.launches = 0


def alu_chain_reference(x: torch.Tensor, mode: str, rounds: int = R * K) -> torch.Tensor:
    """The plain PyTorch version of ``alu_chain`` (any device): the rounds
    one after another, each op rounded to f32."""
    for _ in range(rounds):
        if mode == "add":
            x = x + 1.0000001
        elif mode == "fma":
            x = x * 1.0000001 + 1e-7
        elif mode == "sel":
            x = torch.where(x > 0.5, x + 1.0000001, x - 0.9999999)
        elif mode == "roll":
            x = torch.roll(x, _ROLL, dims=1) + 1.0000001
        else:
            raise ValueError(f"mode must be one of {MODES}")
    return x


def roll_source(Z: int, T: int, t: int, i: int) -> tuple[int, int]:
    """(lane t', register i') of a column's T lanes that register i of lane
    t reads in a round of roll's kernel, each lane holding b = Z / T
    consecutive rows (lane t rows t b .. t b + b - 1): row t b + i takes
    row t b + i - 37 mod Z, as ``torch.roll`` by 37 along Z. With 37 mod Z
    = q b + m, rows i >= m come from register i - m of lane t - q, rows
    i < m from register i - m + b of lane t - q - 1, lanes mod T."""
    b = Z // T
    q, m = divmod(_ROLL % Z, b)
    return ((t - q) % T, i - m) if i >= m else ((t - q - 1) % T, i - m + b)


def planes(n: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """The tool's input, uniform in [0.4, 0.6), for n planes."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.4, 0.6, (n, Z, B)).astype(np.float32)).to(device)


def main():
    print(_kernels.card_line())
    x = planes(PLANES)
    print(f"{PLANES} planes ({Z},{B}) f32, {R * K} chained rounds (R={R} x K={K})")
    for mode in MODES:
        t = _kernels.chain_ms(lambda: alu_chain(x, mode), 5).ms
        rate = PLANES * Z * B * R * K * OPS[mode] / (t * 1e-3)
        print(f"{mode:5s}: {t:8.3f} ms  {rate / 1e12:6.3f} Te-ops/s ({OPS[mode]} op/elem/round)",
              flush=True)
    print(f"issue rate (132 SMs x 4 x 32 lanes x 1.98 GHz): {ISSUE_RATE / 1e12:.1f} T/s; "
          f"data sheet f32: {F32_FLOPS / 1e12:.0f} TFLOP/s")


if __name__ == "__main__":
    main()
