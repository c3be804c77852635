"""5G NR LDPC codes (3GPP TS 38.212).

Base graphs BG1 (46x68) and BG2 (42x52) with all 51 lifting sizes of Table
5.3.2-1. Each base entry expands to a ZxZ circulant ``(r + V_ij) mod Z``
(nr5g.rs:40-53), with V_ij selected by the lifting-size set index iLS
(nr5g.rs:246-261). The V_ij tables (Tables 5.3.2-2/5.3.2-3) load from
``data/nr5g_tables.json``.

A copy of ``ldpc_toolbox_tpu.codes.nr5g``, kept so that this package imports
nothing of the JAX package; ``tests/test_torch_layout.py`` holds the two
equal.
"""

from __future__ import annotations

import json
import pathlib
from enum import Enum

from ..sparse import SparseMatrix

__all__ = ["BaseGraph", "LIFTING_SIZES", "set_index"]

_DATA = json.loads(
    (pathlib.Path(__file__).parent / "data/nr5g_tables.json").read_text()
)

# TS 38.212 Table 5.3.2-1: lifting sizes grouped by set index iLS
_LIFTING_SETS = [
    [2, 4, 8, 16, 32, 64, 128, 256],
    [3, 6, 12, 24, 48, 96, 192, 384],
    [5, 10, 20, 40, 80, 160, 320],
    [7, 14, 28, 56, 112, 224],
    [9, 18, 36, 72, 144, 288],
    [11, 22, 44, 88, 176, 352],
    [13, 26, 52, 104, 208],
    [15, 30, 60, 120, 240],
]

LIFTING_SIZES = sorted(z for s in _LIFTING_SETS for z in s)

_SET_INDEX = {z: i for i, s in enumerate(_LIFTING_SETS) for z in s}


def set_index(z: int) -> int:
    """Set index iLS for a lifting size (nr5g.rs:246-261)."""
    try:
        return _SET_INDEX[z]
    except KeyError:
        raise ValueError(f"invalid 5G NR lifting size {z}") from None


class BaseGraph(Enum):
    BG1 = "1"
    BG2 = "2"

    @property
    def num_rows(self) -> int:
        return {"BG1": 46, "BG2": 42}[self.name]

    @property
    def num_cols(self) -> int:
        return {"BG1": 68, "BG2": 52}[self.name]

    @property
    def graph(self) -> list[list[dict]]:
        """Base graph rows: per base row, a list of {col, vij[8]} entries."""
        return _DATA[self.value]

    def h(self, lifting_size: int) -> SparseMatrix:
        zc = lifting_size
        ils = set_index(zc)
        h = SparseMatrix(self.num_rows * zc, self.num_cols * zc)
        for j, rows in enumerate(self.graph):
            for entry in rows:
                k = entry["col"]
                vij = entry["vij"][ils]
                for r in range(zc):
                    h.insert(zc * j + r, zc * k + (r + vij) % zc)
        return h
