"""Column permutation to systematic-encodable form.

A copy of ``ldpc_toolbox_tpu.systematic`` (numpy only, on this package's
``gf2``), kept so that this package imports nothing of the JAX package;
``tests/test_torch_generic.py`` holds the two equal.

Rebuild of ``src/systematic.rs:31-85``: run GF(2) row echelon on a dense
copy of H; pivot columns move (in order) to the last n rows' positions so
the trailing square submatrix is invertible; non-pivot columns compact to
the front preserving order.
"""

from __future__ import annotations

import numpy as np

from .gf2 import row_echelon_form
from .sparse import SparseMatrix

__all__ = [
    "parity_to_systematic",
    "systematic_permutation",
    "full_rank_rows",
    "permute_columns",
    "SystematicError",
]


class SystematicError(ValueError):
    pass


def systematic_permutation(h: SparseMatrix):
    """The column permutation ``parity_to_systematic`` applies, as an
    index array ``perm`` with ``h_systematic column j = h column
    perm[j]``: pivot columns of the row echelon form move (in order) to
    the last n positions, non-pivot columns compact to the front
    preserving order (src/systematic.rs:31-85). Lets callers encode with
    the permuted matrix while decoding in the original column order
    (e.g. the ``ber`` CLI on CCSDS C2, whose trailing square is
    singular)."""
    n = h.num_rows
    m = h.num_cols
    if n > m:
        raise SystematicError("the parity check matrix has more rows than columns")
    a = h.to_dense()
    row_echelon_form(a)
    if not a[n - 1].any():
        raise SystematicError("the parity check matrix does not have full rank")
    perm = np.empty(m, np.int64)
    k = 0  # write point for non-pivot columns
    j0 = 0
    for j in range(n):
        assert k < m - n
        found = False
        for s in range(j0, m):
            if a[j, s] == 0:
                # non-pivot column: compact to the front
                perm[k] = s
                k += 1
            else:
                # pivot column: move to its slot in the last n columns
                perm[m - n + j] = s
                found = True
                j0 = s + 1
                break
        assert found
    for j in range(j0, m):
        assert k < m - n
        perm[k] = j
        k += 1
    return perm


def full_rank_rows(h: SparseMatrix) -> SparseMatrix:
    """Row-space-preserving reduction to full rank: the nonzero rows of
    the row echelon form. The null space (= the code) is unchanged, so a
    rank-deficient parity check like CCSDS C2's — a 1022-row H of rank
    1020 describing the (8176, **7156**) code (reference
    codes/ccsds.rs:340-342) — can be *encoded* from the reduced matrix
    while the decoder keeps every redundant check. Returns ``h`` itself
    when it is already full rank."""
    a = h.to_dense()
    row_echelon_form(a)
    nz = np.asarray(a.any(axis=1))
    if int(nz.sum()) == h.num_rows:
        return h
    return SparseMatrix.from_dense(a[nz])


def permute_columns(h: SparseMatrix, perm) -> SparseMatrix:
    """New matrix with column j = h column perm[j] (its entries inserted
    column by column, each in h's column order, as the JAX package's
    ``insert_col`` loop does)."""
    cols = [h.col_list(int(s)) for s in perm]
    rows = [r for col in cols for r in col]
    new_cols = np.repeat(np.arange(len(cols)), [len(col) for col in cols])
    return SparseMatrix.from_pairs(h.num_rows, h.num_cols, rows, new_cols)


def parity_to_systematic(h: SparseMatrix) -> SparseMatrix:
    return permute_columns(h, systematic_permutation(h))
