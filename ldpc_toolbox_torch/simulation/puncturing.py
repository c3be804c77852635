"""Block puncturing and depuncturing on torch tensors.

Counterpart of ``ldpc_toolbox_tpu.simulation.puncturing`` (the reference's
``src/simulation/puncturing.rs``): the pattern partitions the codeword into
equal blocks; ``puncture`` drops the False blocks (puncturing.rs:47-73) and
``depuncture`` puts zero LLRs (erasures) in their place
(puncturing.rs:83-101). Both are static gathers of whole blocks: the
codeword seen as (..., blocks, block size), indexed along the blocks.
"""

from __future__ import annotations

import torch

__all__ = ["Puncturer", "PuncturingError"]


class PuncturingError(ValueError):
    pass


class Puncturer:
    def __init__(self, pattern):
        pattern = [bool(b) for b in pattern]
        assert pattern, "puncturing pattern must not be empty"
        self.pattern = pattern
        self.num_trues = sum(pattern)

    def rate(self) -> float:
        """len(pattern) / num_trues >= 1 (puncturing.rs:108-110)."""
        return len(self.pattern) / self.num_trues

    def _block_size(self, codeword_len: int) -> int:
        if codeword_len % len(self.pattern) != 0:
            raise PuncturingError(
                "codeword size not divisible by puncturing pattern length"
            )
        return codeword_len // len(self.pattern)

    def puncture(self, codeword: torch.Tensor) -> torch.Tensor:
        """(..., L) -> (..., L * num_trues / len(pattern))."""
        bs = self._block_size(codeword.shape[-1])
        lead = codeword.shape[:-1]
        kept = [k for k, b in enumerate(self.pattern) if b]
        blocks = codeword.reshape(*lead, len(self.pattern), bs)
        return blocks[..., kept, :].reshape(*lead, len(kept) * bs)

    def depuncture(self, llrs: torch.Tensor) -> torch.Tensor:
        """(..., P) -> (..., L) with zeros at the punctured positions."""
        if llrs.shape[-1] % self.num_trues != 0:
            raise PuncturingError(
                "input size not divisible by number of kept blocks"
            )
        bs = llrs.shape[-1] // self.num_trues
        lead = llrs.shape[:-1]
        # gather from [llrs ‖ 0]: block k reads its kept block if the
        # pattern keeps it, else the appended zero block
        src, j = [], 0
        for b in self.pattern:
            src.append(j if b else self.num_trues)
            j += b
        blocks = torch.cat(
            [llrs.reshape(*lead, self.num_trues, bs), llrs.new_zeros((*lead, 1, bs))],
            dim=-2,
        )
        return blocks[..., src, :].reshape(*lead, len(self.pattern) * bs)
