"""Systematic LDPC encoder on torch tensors.

Counterpart of ``ldpc_toolbox_tpu.encoder``: for H = [H0 H1] with H1
square invertible, the codeword is [message ‖ parity]. Two strategies
(encoder.rs:63-94):

* **staircase** (DVB-S2-style repeat-accumulate, the 2n-1-ones
  double-diagonal test of encoder/staircase.rs:3-24): parity = running
  XOR prefix of the sparse product H0·m, as a gather, a sum and a
  cumulative sum mod 2 along the parity axis, batched over messages;
* **dense generator**: Gauss-reduce [H1 H0] on the host to G0 = H1^{-1}H0
  (once per code); parity = G0·m mod 2 as a float32 product (exact: row
  sums stay below 2^24).

``encode`` takes one message through the same tables on the host, in
numpy (encoder.rs's single-codeword ``encode``).
"""

from __future__ import annotations

import numpy as np
import torch

from .gf2 import NotInvertibleError, gauss_reduction
from .sparse import SparseMatrix

__all__ = ["Encoder", "EncoderError", "is_staircase"]


class EncoderError(ValueError):
    """The trailing square submatrix of H is not invertible."""


def is_staircase(h: SparseMatrix) -> bool:
    """True iff the parity part of H is exactly the staircase double
    diagonal (encoder/staircase.rs:3-24)."""
    n = h.num_rows
    m = h.num_cols
    num_checked = 0
    for j, k in h.iter_all():
        if k >= m - n:
            if j == 0 and k != m - n:
                return False
            if j != 0 and k != m - n + j - 1 and k != m - n + j:
                return False
            num_checked += 1
    return num_checked == 2 * n - 1


class Encoder:
    """Systematic encoder for a parity-check matrix."""

    def __init__(self, h: SparseMatrix, device="cuda"):
        """``device``: where ``encode_batch`` runs (its tables live there)."""
        n = h.num_rows
        m = h.num_cols
        self.n_rows = n
        self.n_cols = m
        self.k = m - n
        self.staircase = is_staircase(h)
        if self.staircase:
            # H0 rows as a padded gather table; padding points at a sentinel
            # zero message bit appended at index k
            rows = [[c for c in h.row_list(r) if c < self.k] for r in range(n)]
            d = max((len(r) for r in rows), default=1) or 1
            idx = np.full((n, d), self.k, dtype=np.int64)
            for r, row in enumerate(rows):
                idx[r, : len(row)] = row
            self._h0_idx_host = idx
            self._h0_idx = torch.as_tensor(idx, device=device)
        else:
            # A = [H1 H0]; after Gauss-Jordan the right block is G0 = H1^-1 H0
            a = np.zeros((n, m), dtype=np.uint8)
            for j, kk in h.iter_all():
                t = kk + n if kk < m - n else kk - (m - n)
                a[j, t] = 1
            try:
                gauss_reduction(a)
            except NotInvertibleError:
                raise EncoderError(
                    "the square matrix formed by the last columns of the "
                    "parity check is not invertible"
                ) from None
            self._g0 = a[:, n:]  # (n, k) uint8, for encode
            self._g0t = torch.as_tensor(
                a[:, n:].T.astype(np.float32), device=device
            )

    def encode_batch(self, messages: torch.Tensor) -> torch.Tensor:
        """(B, k) 0/1 -> (B, n_cols) 0/1 uint8, on the encoder's device."""
        if messages.ndim != 2 or messages.shape[1] != self.k:
            raise ValueError(f"expected (B, {self.k}) messages")
        msg = messages.to(torch.uint8)
        if self.staircase:
            idx = self._h0_idx
            ext = torch.cat([msg, msg.new_zeros((msg.shape[0], 1))], dim=1)
            g = ext[:, idx.reshape(-1)].reshape(msg.shape[0], *idx.shape)
            pre = g.sum(dim=2, dtype=torch.int32) & 1  # (B, n_rows)
            parity = torch.cumsum(pre, dim=1, dtype=torch.int32) & 1
        else:
            prod = msg.to(torch.float32) @ self._g0t
            parity = prod.to(torch.int32) & 1
        return torch.cat([msg, parity.to(torch.uint8)], dim=1)

    def encode(self, message) -> np.ndarray:
        """Encode a single (k,) message on the host (numpy in and out)."""
        message = np.asarray(message)
        if self.staircase:
            bits = np.concatenate([message.astype(np.uint8), [0]])
            pre = bits[self._h0_idx_host].sum(axis=1) & 1
            parity = np.bitwise_and(np.cumsum(pre), 1).astype(np.uint8)
        else:
            parity = (self._g0.astype(np.uint32) @ message.astype(np.uint32)) & 1
        return np.concatenate([message.astype(np.uint8), parity.astype(np.uint8)])
