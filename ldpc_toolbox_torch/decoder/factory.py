"""Decoder registry keyed by the reference's implementation names.

All 44 names of ``ldpc_toolbox_tpu.decoder.factory.DECODER_IMPLEMENTATIONS``
resolve here: 28 flooding names and 16 ``HL*`` horizontal-layered names,
each to its arithmetic: the reference's Phi, Tanh, Minstarapprox and
Aminstar families in f64 and f32 and their i8 forms, and the min-sum
extensions. ``*f64`` names compute in float64 on every device.
"""

from __future__ import annotations

from typing import Callable

import torch

from .arithmetic import (
    AminstarArithmetic,
    AminstarI8Arithmetic,
    Arithmetic,
    MinstarApproxArithmetic,
    MinstarApproxI8Arithmetic,
    MinSumArithmetic,
    PhiArithmetic,
    TanhArithmetic,
)

__all__ = ["DECODER_IMPLEMENTATIONS", "make_arithmetic"]


def _i8_combos(prefix: str, ctor) -> dict:
    """The 8 Jones/PartialHardLimit/Deg1Clip combinations of an i8 family
    (arithmetic.rs:850-897, 1262-1304)."""
    return {
        prefix + "Jones" * j + "PartialHardLimit" * h + "Deg1Clip" * c: (
            lambda j=j, h=h, c=c: ctor(
                jones=bool(j), hard_limit=bool(h), deg1_clip=bool(c)
            )
        )
        for j in (0, 1)
        for h in (0, 1)
        for c in (0, 1)
    }

_FLOODING_ARITHS: dict[str, Callable[[], Arithmetic]] = {
    "Phif64": lambda: PhiArithmetic(torch.float64),
    "Phif32": lambda: PhiArithmetic(torch.float32),
    "Tanhf64": lambda: TanhArithmetic(torch.float64, clamp=18.0),
    "Tanhf32": lambda: TanhArithmetic(torch.float32, clamp=9.0),
    "Minstarapproxf64": lambda: MinstarApproxArithmetic(torch.float64),
    "Minstarapproxf32": lambda: MinstarApproxArithmetic(torch.float32),
    "Aminstarf64": lambda: AminstarArithmetic(torch.float64),
    "Aminstarf32": lambda: AminstarArithmetic(torch.float32),
    # framework extensions: plain and normalized (scale 0.75) min-sum,
    # with f32 or bf16 message storage
    "Minsumf32": lambda: MinSumArithmetic(torch.float32),
    "Minsumbf16": lambda: MinSumArithmetic(
        torch.float32, storage=torch.bfloat16
    ),
    "Normminsumf32": lambda: MinSumArithmetic(torch.float32, scale=0.75),
    "Normminsumbf16": lambda: MinSumArithmetic(
        torch.float32, scale=0.75, storage=torch.bfloat16
    ),
    **_i8_combos("Minstarapproxi8", MinstarApproxI8Arithmetic),
    **_i8_combos("Aminstari8", AminstarI8Arithmetic),
}

# the HL (horizontal layered) subset exposed by the reference
_HL_NAMES = [
    "Phif64",
    "Phif32",
    "Tanhf64",
    "Tanhf32",
    "Minstarapproxf64",
    "Minstarapproxf32",
    "Minstarapproxi8",
    "Minstarapproxi8PartialHardLimit",
    "Aminstarf64",
    "Aminstarf32",
    "Aminstari8",
    "Aminstari8PartialHardLimit",
    "Minsumf32",
    "Minsumbf16",
    "Normminsumf32",
    "Normminsumbf16",
]

#: name -> (schedule, arithmetic factory); schedule in {"flooding", "layered"}
DECODER_IMPLEMENTATIONS: dict[str, tuple[str, Callable[[], Arithmetic]]] = {
    **{name: ("flooding", f) for name, f in _FLOODING_ARITHS.items()},
    **{f"HL{name}": ("layered", _FLOODING_ARITHS[name]) for name in _HL_NAMES},
}


def make_arithmetic(name: str) -> tuple[str, Arithmetic]:
    """Returns (schedule, arithmetic instance) for an implementation name."""
    try:
        schedule, factory = DECODER_IMPLEMENTATIONS[name]
    except KeyError:
        raise ValueError(f"invalid decoder implementation {name!r}") from None
    return schedule, factory()
