"""AWGN channel on torch tensors.

Counterpart of ``ldpc_toolbox_tpu.simulation.channel`` (the reference's
``src/simulation/channel.rs:36-88``): adds N(0, sigma) noise per real
dimension, drawn from an explicit ``torch.Generator``. Complex symbols get
independent real and imaginary components, each of standard deviation
sigma: two real draws, the real part's first.
"""

from __future__ import annotations

import torch

__all__ = ["AwgnChannel"]


class AwgnChannel:
    """Stateless AWGN channel."""

    @staticmethod
    def add_noise(symbols: torch.Tensor, noise_sigma: float, generator):
        if symbols.is_complex():
            # not randn(dtype=complex64): that gives each part variance 1/2
            draw = dict(generator=generator, dtype=torch.float32, device=symbols.device)
            re = torch.randn(symbols.shape, **draw)
            im = torch.randn(symbols.shape, **draw)
            return symbols + torch.complex(noise_sigma * re, noise_sigma * im)
        noise = torch.randn(
            symbols.shape, generator=generator, dtype=symbols.dtype,
            device=symbols.device,
        )
        return symbols + noise_sigma * noise
