"""Belief-propagation LDPC decoders on torch tensors.

Public API::

    dec = Decoder(Code.R1_2, "Minsumbf16")            # on the card
    out = dec.decode_batch(llrs, max_iterations=30)    # (B, n) LLRs
    single = dec.decode(llrs_1d, max_iterations=30)    # one frame

``decode`` mirrors the reference's ``LdpcDecoder::decode`` contract
(decoder.rs:19-35): the returned ``DecoderOutput`` carries the hard
decision, the iteration count (0 if the input already satisfied H,
``max_iterations`` on failure) and a success flag.

All 44 names of both schedules (the float, i8 and min-sum rules;
``Phif64``, the reference's default, when no name is given): the ``HL*``
names decode layered, the others flooding. Standards code objects and 5G
``(BaseGraph, Z)`` pairs take the lifted layout (``lifted_layered``,
``lifted_flooding``, the hand-written kernels on the card); a generic
``SparseMatrix`` (an alist) or a ``DecodeGraph`` takes the generic
parity-check path (``layered``, ``flooding``: torch ops on the compact
and padded tables of ``layout.DecodeGraph``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..sparse import SparseMatrix

from .factory import DECODER_IMPLEMENTATIONS, make_arithmetic  # noqa: F401
from .flooding import flooding_decode
from .layered import layered_decode
from .layout import DecodeGraph
from .lifted import LiftedGraph, lifted_graph_for, nr5g_maps
from .lifted_flooding import lifted_flooding_decode
from .lifted_layered import lifted_layered_decode

__all__ = [
    "Decoder",
    "DecoderOutput",
    "DecodeGraph",
    "DECODER_IMPLEMENTATIONS",
    "flooding_decode",
    "generic_decode_for",
    "layered_decode",
    "lifted_decode_for",
]


def lifted_decode_for(schedule: str):
    """The lifted decode function of a schedule, "flooding" or "layered"
    (the first item ``make_arithmetic`` returns)."""
    return lifted_flooding_decode if schedule == "flooding" else lifted_layered_decode


def generic_decode_for(schedule: str):
    """The generic parity-check decode function of a schedule."""
    return flooding_decode if schedule == "flooding" else layered_decode


@dataclass
class DecoderOutput:
    codeword: np.ndarray  # (n,) uint8 hard decisions
    iterations: int
    success: bool


class Decoder:
    """A batched LDPC decoder for a fixed code on one device."""

    def __init__(self, h, implementation: str = "Phif64", device="cuda"):
        """``h``: a ``SparseMatrix`` or a ``DecodeGraph`` (the generic
        parity-check decode), a standards code object
        (``codes.dvbs2.Code``, ``AR4JACode``, ``C2Code``) or a
        ``(BaseGraph, Z)`` pair for 5G NR (the lifted decode).
        ``device``: where the LLRs are decoded; on a CUDA device the lifted
        decode runs the hand-written kernels, on ``"cpu"`` their plain
        versions; the generic decode runs the same torch ops on either."""
        self.implementation = implementation
        self.schedule, self.arithmetic = make_arithmetic(implementation)
        self.device = torch.device(device)
        self.lifted = self.graph = None
        if isinstance(h, (SparseMatrix, DecodeGraph)):
            self.graph = h if isinstance(h, DecodeGraph) else DecodeGraph.from_sparse(h)
            self._decode = generic_decode_for(self.schedule)
            return
        if isinstance(h, tuple):  # (BaseGraph, lifting size Z)
            bg, z = h
            self.lifted = LiftedGraph.from_sparse(bg.h(z), *nr5g_maps(bg, z))
        else:
            self.lifted = lifted_graph_for(h)
            if self.lifted is None:
                raise TypeError(f"unsupported code object {type(h).__name__}")
        self._decode = lifted_decode_for(self.schedule)

    @property
    def _code(self):
        """The layout the decode function takes: the LiftedGraph or the
        DecodeGraph."""
        return self.graph if self.lifted is None else self.lifted

    @property
    def n(self) -> int:
        return self._code.n

    def decode_batch(self, llrs, max_iterations: int = 100):
        """Decode a (B, n) batch of channel LLR frames.

        Returns a dict of tensors on the decoder's device: ``codeword``
        (B, n) uint8, ``iterations`` (B,) int32, ``success`` (B,) bool.
        """
        llrs = torch.as_tensor(llrs, device=self.device)
        if llrs.ndim != 2 or llrs.shape[1] != self.n:
            raise ValueError(f"expected (B, {self.n}) LLRs, got {tuple(llrs.shape)}")
        return self._decode(self._code, self.arithmetic, llrs, max_iterations)

    def decode(self, llrs, max_iterations: int = 100) -> DecoderOutput:
        """Decode a single (n,) frame (convenience wrapper)."""
        llrs = torch.as_tensor(llrs, device=self.device)
        out = self.decode_batch(llrs[None, :], max_iterations)
        return DecoderOutput(
            codeword=out["codeword"][0].cpu().numpy(),
            iterations=int(out["iterations"][0]),
            success=bool(out["success"][0]),
        )
