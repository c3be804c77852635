"""The staircase (repeat-accumulate) encode of a DVB-S2 code.

The codeword is [message | parity]: each check row r sums the message
bits it holds into a(r), mod 2, and the parity bits accumulate them,
p(0) = a(0), p(r) = p(r - 1) + a(r), mod 2 (EN 302 307-1 §5.3.2.1).
"""

from __future__ import annotations

import torch

__all__ = ["staircase_encode"]


BLOCK = 256  # frames a pass, so that the gathered message bits fit


def staircase_encode(code, msg):
    """(B, k) 0/1 uint8 messages -> (B, n) uint8 codewords of ``code``
    (``dvbs2.Dvbs2Code``), on the messages' device."""
    rows, cols = code.edges()
    info = cols < code.k
    rows = torch.as_tensor(rows[info], device=msg.device)
    cols = torch.as_tensor(cols[info], device=msg.device)
    parity = []
    for m in msg.split(BLOCK):
        acc = torch.zeros((m.shape[0], code.m), dtype=torch.int32, device=msg.device)
        acc.index_add_(1, rows, m[:, cols].to(torch.int32))
        parity.append(torch.cumsum(acc & 1, dim=1) & 1)
    return torch.cat([msg, torch.cat(parity).to(torch.uint8)], dim=1)
