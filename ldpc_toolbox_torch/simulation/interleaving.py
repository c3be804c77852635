"""DVB-S2 block (column) interleaver on torch tensors.

Counterpart of ``ldpc_toolbox_tpu.simulation.interleaving`` (the
reference's ``src/simulation/interleaving.rs``): the codeword as
(columns, len/columns), transposed, its rows optionally read backwards (the
8PSK rate-3/5 case), flattened (interleaving.rs:28-85).
"""

from __future__ import annotations

import torch

__all__ = ["Interleaver"]


class Interleaver:
    def __init__(self, columns: int, read_rows_backwards: bool = False):
        self.columns = columns
        self.read_rows_backwards = read_rows_backwards

    def interleave(self, codeword: torch.Tensor) -> torch.Tensor:
        """(..., L) -> (..., L), L % columns == 0."""
        L = codeword.shape[-1]
        assert L % self.columns == 0
        a = codeword.reshape(*codeword.shape[:-1], self.columns, L // self.columns)
        t = a.transpose(-1, -2)  # (..., L/cols, cols)
        if self.read_rows_backwards:
            t = t.flip(-1)
        # the transpose is not contiguous: reshape copies where view cannot
        return t.reshape(*codeword.shape[:-1], L)

    def deinterleave(self, codeword: torch.Tensor) -> torch.Tensor:
        L = codeword.shape[-1]
        assert L % self.columns == 0
        a = codeword.reshape(*codeword.shape[:-1], L // self.columns, self.columns)
        if self.read_rows_backwards:
            a = a.flip(-1)
        t = a.transpose(-1, -2)  # (..., cols, L/cols)
        return t.reshape(*codeword.shape[:-1], L)
