"""Dense GF(2) linear algebra on the host.

Vectorized numpy equivalents of the reference's scalar Gauss-Jordan routines
(``src/linalg.rs:8-110``). Matrices are 0/1 ``uint8`` arrays; addition is
XOR and multiplication is AND, so the generic division steps of the
reference collapse away (every nonzero pivot is 1).

These routines run once per code during encoder construction / systematic
permutation — they are host work by design, not kernels.

A copy of ``ldpc_toolbox_tpu.gf2``, kept so that this package imports
nothing of the JAX package; ``tests/test_torch_layout.py`` holds the two
equal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["NotInvertibleError", "gauss_reduction", "row_echelon_form", "gf2_matmul"]


class NotInvertibleError(ValueError):
    """The leading square submatrix is singular (linalg.rs:4-6)."""


def gauss_reduction(a: np.ndarray) -> np.ndarray:
    """Reduce ``a`` (n x m, n <= m) so its first n columns become identity.

    In-place semantics of linalg.rs:8-66: Gauss-Jordan over GF(2) using the
    first ``n`` columns as pivots. Raises :class:`NotInvertibleError` if the
    leading n x n submatrix is singular. Returns ``a`` (modified in place).
    """
    a = np.ascontiguousarray(a, dtype=np.uint8)
    n, m = a.shape
    if n > m:
        raise ValueError("matrix must have at least as many columns as rows")

    for j in range(n):
        col = a[j:, j]
        nz = np.nonzero(col)[0]
        if nz.size == 0:
            raise NotInvertibleError("leading square submatrix is singular")
        k = j + int(nz[0])
        if k != j:
            a[[j, k]] = a[[k, j]]
        # eliminate below the pivot (single broadcast XOR per pivot)
        below = a[j + 1 :, j].astype(bool)
        if below.any():
            a[j + 1 :][below] ^= a[j]

    # back-substitution: eliminate above each pivot
    for j in range(n - 1, 0, -1):
        above = a[:j, j].astype(bool)
        if above.any():
            a[:j][above] ^= a[j]
    return a


def row_echelon_form(a: np.ndarray) -> np.ndarray:
    """Reduce ``a`` to (non-reduced) row echelon form over GF(2).

    Matches linalg.rs:68-110: scans columns left to right, swapping up a
    pivot row when one exists and clearing entries below it. Returns ``a``
    (modified in place).
    """
    a = np.ascontiguousarray(a, dtype=np.uint8)
    n, m = a.shape
    j = 0
    k = 0
    while j < m and k < n:
        col = a[k:, j]
        nz = np.nonzero(col)[0]
        if nz.size == 0:
            j += 1
            continue
        s = k + int(nz[0])
        if s != k:
            a[[s, k]] = a[[k, s]]
        below = a[k + 1 :, j].astype(bool)
        if below.any():
            a[k + 1 :][below] ^= a[k]
        j += 1
        k += 1
    return a


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2) matrix product of 0/1 uint8 arrays."""
    return (
        a.astype(np.uint32) @ b.astype(np.uint32) & 1
    ).astype(np.uint8)
