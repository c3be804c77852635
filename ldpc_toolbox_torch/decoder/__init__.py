"""Belief-propagation LDPC decoders on torch tensors.

Public API::

    dec = Decoder(Code.R1_2, "Minsumbf16")            # on the card
    out = dec.decode_batch(llrs, max_iterations=30)    # (B, n) LLRs
    single = dec.decode(llrs_1d, max_iterations=30)    # one frame

``decode`` mirrors the reference's ``LdpcDecoder::decode`` contract
(decoder.rs:19-35): the returned ``DecoderOutput`` carries the hard
decision, the iteration count (0 if the input already satisfied H,
``max_iterations`` on failure) and a success flag.

Ported so far: standards code objects and 5G ``(BaseGraph, Z)`` pairs on
the lifted layout, with all 44 names of both schedules (the float, i8 and
min-sum rules; ``Phif64``, the reference's default, when no name is
given): the ``HL*`` names decode layered (``lifted_layered``), the others
flooding (``lifted_flooding``). A generic ``SparseMatrix`` waits for
ROADMAP A8.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..sparse import SparseMatrix

from .factory import DECODER_IMPLEMENTATIONS, make_arithmetic  # noqa: F401
from .lifted import LiftedGraph, lifted_graph_for, nr5g_maps
from .lifted_flooding import lifted_flooding_decode
from .lifted_layered import lifted_layered_decode

__all__ = [
    "Decoder",
    "DecoderOutput",
    "DECODER_IMPLEMENTATIONS",
    "lifted_decode_for",
]


def lifted_decode_for(schedule: str):
    """The lifted decode function of a schedule, "flooding" or "layered"
    (the first item ``make_arithmetic`` returns)."""
    return lifted_flooding_decode if schedule == "flooding" else lifted_layered_decode


@dataclass
class DecoderOutput:
    codeword: np.ndarray  # (n,) uint8 hard decisions
    iterations: int
    success: bool


class Decoder:
    """A batched LDPC decoder for a fixed standards code on one device."""

    def __init__(self, h, implementation: str = "Phif64", device="cuda"):
        """``h``: a standards code object (``codes.dvbs2.Code``,
        ``AR4JACode``, ``C2Code``) or a ``(BaseGraph, Z)`` pair for 5G NR.
        ``device``: where the LLRs are decoded; on a CUDA device the decode
        runs the hand-written kernels, on ``"cpu"`` their plain versions."""
        if isinstance(h, SparseMatrix):
            raise NotImplementedError(
                "the generic parity-check path is not ported yet (ROADMAP A8)"
            )
        if isinstance(h, tuple):  # (BaseGraph, lifting size Z)
            bg, z = h
            self.lifted = LiftedGraph.from_sparse(bg.h(z), *nr5g_maps(bg, z))
        else:
            self.lifted = lifted_graph_for(h)
            if self.lifted is None:
                raise TypeError(f"unsupported code object {type(h).__name__}")
        self.implementation = implementation
        self.schedule, self.arithmetic = make_arithmetic(implementation)
        self._decode = lifted_decode_for(self.schedule)
        self.device = torch.device(device)

    @property
    def n(self) -> int:
        return self.lifted.n

    def decode_batch(self, llrs, max_iterations: int = 100):
        """Decode a (B, n) batch of channel LLR frames.

        Returns a dict of tensors on the decoder's device: ``codeword``
        (B, n) uint8, ``iterations`` (B,) int32, ``success`` (B,) bool.
        """
        llrs = torch.as_tensor(llrs, device=self.device)
        if llrs.ndim != 2 or llrs.shape[1] != self.n:
            raise ValueError(f"expected (B, {self.n}) LLRs, got {tuple(llrs.shape)}")
        return self._decode(self.lifted, self.arithmetic, llrs, max_iterations)

    def decode(self, llrs, max_iterations: int = 100) -> DecoderOutput:
        """Decode a single (n,) frame (convenience wrapper)."""
        llrs = torch.as_tensor(llrs, device=self.device)
        out = self.decode_batch(llrs[None, :], max_iterations)
        return DecoderOutput(
            codeword=out["codeword"][0].cpu().numpy(),
            iterations=int(out["iterations"][0]),
            success=bool(out["success"][0]),
        )
