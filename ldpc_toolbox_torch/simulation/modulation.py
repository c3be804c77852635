"""Modulation and demodulation on torch tensors.

Counterpart of ``ldpc_toolbox_tpu.simulation.modulation`` for BPSK
(modulation.rs:87-129): bit 0 -> -1.0, bit 1 -> +1.0; LLR = -2x/sigma^2,
negative because +1 carries bit 1 while LLR > 0 means bit 0. 8PSK waits
for ROADMAP A9.
"""

from __future__ import annotations

import torch

__all__ = ["Bpsk"]


class Bpsk:
    BITS_PER_SYMBOL = 1.0

    def modulate(self, bits: torch.Tensor) -> torch.Tensor:
        """(..., L) 0/1 -> (..., L) float32 symbols."""
        return torch.where(bits == 0, -1.0, 1.0).to(torch.float32)

    def demodulate(self, symbols: torch.Tensor, noise_sigma: float):
        """LLR = -2x/sigma^2."""
        return (-2.0 / (noise_sigma * noise_sigma)) * symbols
