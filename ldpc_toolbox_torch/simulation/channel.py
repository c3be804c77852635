"""AWGN channel on torch tensors.

Counterpart of ``ldpc_toolbox_tpu.simulation.channel`` for real symbols:
adds N(0, sigma) noise drawn from an explicit ``torch.Generator``
(channel.rs:36-88). Complex symbols wait with 8PSK (ROADMAP A9).
"""

from __future__ import annotations

import torch

__all__ = ["AwgnChannel"]


class AwgnChannel:
    """Stateless AWGN channel."""

    @staticmethod
    def add_noise(symbols: torch.Tensor, noise_sigma: float, generator):
        if symbols.is_complex():
            raise NotImplementedError("complex symbols wait for 8PSK (ROADMAP A9)")
        noise = torch.randn(
            symbols.shape, generator=generator, dtype=symbols.dtype,
            device=symbols.device,
        )
        return symbols + noise_sigma * noise
