"""The channel of a ``ber`` step: modulation, AWGN and the LLR demap.

* sigma = sqrt(0.5 / (rate * bits per symbol * 10^(Eb/N0 / 10))), the
  rate k/n (ber.rs:246-302);
* BPSK: bit 0 -> -1, bit 1 -> +1; LLR = -2 y / sigma^2, positive for a
  likely 0 (modulation.rs:87-129);
* 8PSK: the DVB-S2 Gray constellation (EN 302 307-1 §5.4.2, Figure 11)
  on the triplets (b0, b1, b2) of the interleaved codeword; noise on the
  real part, then the imaginary part, each of deviation sigma; per bit
  the exact max-* demap, max* over the points where the bit is 0 less
  max* over those where it is 1 of (y . point) / sigma^2, each max*
  folded over the points in index order as
  max(a, b) + log(1 + exp(-|a - b|)) (modulation.rs:146-288);
* the DVB-S2 block interleaver (EN 302 307-1 §5.3.3): written down
  ``columns`` columns, read along the rows, for 8PSK rate 3/5 each row
  read from the last column (interleaving.rs:28-85).

The noise is drawn from the step's generator after the message, in the
order above. ``dtype`` computes the channel in another type (bfloat16 in
the control); the draws stay float32.
"""

from __future__ import annotations

import math

import torch

__all__ = ["deinterleave", "interleave", "llrs", "sigma", "PSK8_POINTS"]

_A = math.sqrt(0.5)
#: the 8PSK point of the bits (b0, b1, b2) at index 4 b0 + 2 b1 + b2
PSK8_POINTS = (
    complex(_A, _A),     # 000
    complex(1.0, 0.0),   # 001
    complex(-1.0, 0.0),  # 010
    complex(-_A, -_A),   # 011
    complex(0.0, 1.0),   # 100
    complex(_A, -_A),    # 101
    complex(-_A, _A),    # 110
    complex(0.0, -1.0),  # 111
)
BITS_PER_SYMBOL = {"BPSK": 1, "8PSK": 3}


def sigma(ebn0_db, rate, modulation):
    """The noise deviation at an Eb/N0."""
    esn0 = rate * BITS_PER_SYMBOL[modulation] * 10.0 ** (0.1 * float(ebn0_db))
    return float(math.sqrt(0.5 / esn0))


def interleave(bits, columns, backwards):
    B, L = bits.shape
    t = bits.reshape(B, columns, L // columns).transpose(1, 2)
    return (t.flip(-1) if backwards else t).reshape(B, L)


def deinterleave(values, columns, backwards):
    B, L = values.shape
    t = values.reshape(B, L // columns, columns)
    t = t.flip(-1) if backwards else t
    return t.transpose(1, 2).reshape(B, L)


def _maxstar(values):
    acc = values[0]
    for v in values[1:]:
        acc = torch.logaddexp(acc, v)
    return acc


def llrs(cw, s, modulation, generator, interleaving=None, dtype=torch.float32):
    """(B, n) codewords -> (B, n) float32 LLRs through the channel, the
    noise of deviation ``s`` drawn from ``generator``; ``interleaving`` the
    interleaver's columns, negative to read the rows backwards."""
    draw = dict(generator=generator, dtype=torch.float32, device=cw.device)
    if interleaving:
        cw = interleave(cw, abs(interleaving), interleaving < 0)
    if modulation == "BPSK":
        x = torch.where(cw == 0, -1.0, 1.0).to(dtype)
        noise = torch.randn(cw.shape, **draw).to(dtype)
        y = x + s * noise
        out = ((-2.0 / (s * s)) * y).float()
    elif modulation == "8PSK":
        B, L = cw.shape
        trip = cw.reshape(B, L // 3, 3).to(torch.int64)
        index = trip[..., 0] * 4 + trip[..., 1] * 2 + trip[..., 2]
        re_pt = torch.tensor([p.real for p in PSK8_POINTS], dtype=torch.float32,
                             device=cw.device)
        im_pt = torch.tensor([p.imag for p in PSK8_POINTS], dtype=torch.float32,
                             device=cw.device)
        nre = torch.randn(index.shape, **draw)
        nim = torch.randn(index.shape, **draw)
        yre = (re_pt[index] + s * nre).to(dtype)
        yim = (im_pt[index] + s * nim).to(dtype)
        scale = 1.0 / (s * s)
        yre, yim = yre * scale, yim * scale
        dots = [yre * float(re_pt[p]) + yim * float(im_pt[p]) for p in range(8)]
        bits = []
        for b in (4, 2, 1):
            zeros = [dots[p] for p in range(8) if not p & b]
            ones = [dots[p] for p in range(8) if p & b]
            bits.append(_maxstar(zeros) - _maxstar(ones))
        out = torch.stack(bits, dim=-1).reshape(B, L).float()
    else:
        raise ValueError(f"unknown modulation {modulation!r}")
    if interleaving:
        out = deinterleave(out, abs(interleaving), interleaving < 0)
    return out
