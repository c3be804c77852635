"""Modulation and demodulation on torch tensors.

Counterpart of ``ldpc_toolbox_tpu.simulation.modulation`` (the
reference's ``src/simulation/modulation.rs``):

* **BPSK**: bit 0 -> -1.0, bit 1 -> +1.0 (modulation.rs:87-95); LLR =
  -2x/sigma^2, negative because +1 carries bit 1 while LLR > 0 means bit 0
  (modulation.rs:123-129).
* **8PSK**: the DVB-S2 Gray constellation (modulation.rs:168-180) with the
  exact max-* LLR demapper per 3-bit symbol scaled by 1/sigma^2
  (modulation.rs:222-264), in float32 from complex64 symbols.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Bpsk", "Psk8"]


class Bpsk:
    BITS_PER_SYMBOL = 1.0
    COMPLEX = False

    def modulate(self, bits: torch.Tensor) -> torch.Tensor:
        """(..., L) 0/1 -> (..., L) float32 symbols."""
        return torch.where(bits == 0, -1.0, 1.0).to(torch.float32)

    def demodulate(self, symbols: torch.Tensor, noise_sigma: float):
        """LLR = -2x/sigma^2."""
        return (-2.0 / (noise_sigma * noise_sigma)) * symbols


_A = math.sqrt(0.5)
# DVB-S2 Gray 8PSK: the symbol of (b0, b1, b2) at index b0*4 + b1*2 + b2
_PSK8_POINTS = np.zeros(8, dtype=np.complex64)
for _bits, _pt in [
    ((0, 0, 0), complex(_A, _A)),
    ((1, 0, 0), complex(0.0, 1.0)),
    ((1, 1, 0), complex(-_A, _A)),
    ((0, 1, 0), complex(-1.0, 0.0)),
    ((0, 1, 1), complex(-_A, -_A)),
    ((1, 1, 1), complex(0.0, -1.0)),
    ((1, 0, 1), complex(_A, -_A)),
    ((0, 0, 1), complex(1.0, 0.0)),
]:
    _PSK8_POINTS[_bits[0] * 4 + _bits[1] * 2 + _bits[2]] = _pt

# the constellation points where each bit is 0
_BIT0_ZERO = [i for i in range(8) if not (i >> 2) & 1]
_BIT1_ZERO = [i for i in range(8) if not (i >> 1) & 1]
_BIT2_ZERO = [i for i in range(8) if not i & 1]


#: the points' coordinates as the float32 values the JAX package multiplies by
_PSK8_RE = [float(np.float32(p.real)) for p in _PSK8_POINTS]
_PSK8_IM = [float(np.float32(p.imag)) for p in _PSK8_POINTS]


def _maxstar_fold(d, points) -> torch.Tensor:
    """max* of ``d[p]`` over ``points``, folded in their order:
    acc = max(acc, b) + log1p(exp(-|acc - b|)) (modulation.rs:286-288),
    which is what ``torch.logaddexp`` computes, in one pass."""
    acc = d[points[0]]
    for i in points[1:]:
        acc = torch.logaddexp(acc, d[i])
    return acc


class Psk8:
    BITS_PER_SYMBOL = 3.0
    COMPLEX = True

    def modulate(self, bits: torch.Tensor) -> torch.Tensor:
        """(..., L) 0/1 with L % 3 == 0 -> (..., L/3) complex64 symbols."""
        assert bits.shape[-1] % 3 == 0
        trip = bits.reshape(*bits.shape[:-1], -1, 3).to(torch.int64)
        idx = trip[..., 0] * 4 + trip[..., 1] * 2 + trip[..., 2]
        return torch.as_tensor(_PSK8_POINTS, device=bits.device)[idx]

    def demodulate(self, symbols: torch.Tensor, noise_sigma: float):
        """(..., S) complex64 -> (..., 3*S) float32 LLRs; exact max-*."""
        scale = 1.0 / (noise_sigma * noise_sigma)
        re = symbols.real * scale
        im = symbols.imag * scale
        # dot(symbol, point) = re*re + im*im for each of the 8 points, a
        # contiguous (..., S) tensor each
        d = [re * pr + im * pi for pr, pi in zip(_PSK8_RE, _PSK8_IM)]
        llr = []
        for zeros in (_BIT0_ZERO, _BIT1_ZERO, _BIT2_ZERO):
            ones = [i for i in range(8) if i not in zeros]
            llr.append(_maxstar_fold(d, zeros) - _maxstar_fold(d, ones))
        out = torch.stack(llr, dim=-1)  # (..., S, 3)
        return out.reshape(*out.shape[:-2], -1)
