"""DVB-S2 LDPC codes (ETSI EN 302 307-1).

All 32 LDPC codes (11 normal-frame n=64800 + 10 short-frame n=16200,
exposed as 21 named variants like the reference's ``codes::dvbs2::Code``
enum, dvbs2.rs:21-69). H is built per section 5.3.2.1: systematic column
``j`` gets rows ``(x + (j % 360) * q) mod m`` for each accumulator address
``x`` in the Annex B table row ``j // 360``; the parity part is the
staircase double diagonal (dvbs2.rs:79-98).

The codes are 360-lifted protographs: that structure is what the decoder's
block-circulant fast path exploits.

A copy of ``ldpc_toolbox_tpu.codes.dvbs2``, kept so that this package imports
nothing of the JAX package; ``tests/test_torch_layout.py`` holds the two
equal.
"""

from __future__ import annotations

import json
import pathlib
from enum import Enum

from ..sparse import SparseMatrix

__all__ = ["Code"]

_DATA = json.loads(
    (pathlib.Path(__file__).parent / "data/dvbs2_tables.json").read_text()
)


class Code(Enum):
    R1_4 = "1/4"
    R1_3 = "1/3"
    R2_5 = "2/5"
    R1_2 = "1/2"
    R3_5 = "3/5"
    R2_3 = "2/3"
    R3_4 = "3/4"
    R4_5 = "4/5"
    R5_6 = "5/6"
    R8_9 = "8/9"
    R9_10 = "9/10"
    R1_4short = "1/4 short"
    R1_3short = "1/3 short"
    R2_5short = "2/5 short"
    R1_2short = "1/2 short"
    R3_5short = "3/5 short"
    R2_3short = "2/3 short"
    R3_4short = "3/4 short"
    R4_5short = "4/5 short"
    R5_6short = "5/6 short"
    R8_9short = "8/9 short"

    @property
    def is_short(self) -> bool:
        return self.name.endswith("short")

    @property
    def n(self) -> int:
        return 16200 if self.is_short else 64800

    @property
    def m(self) -> int:
        # Rows of H per code (dvbs2.rs:133-157); short-frame nominal rates
        # differ from the LDPC rate for some codes.
        n = self.n
        return {
            "R1_4": n * 3 // 4,
            "R1_3": n * 2 // 3,
            "R2_5": n * 3 // 5,
            "R1_2": n // 2,
            "R3_5": n * 2 // 5,
            "R2_3": n // 3,
            "R3_4": n // 4,
            "R4_5": n // 5,
            "R5_6": n // 6,
            "R8_9": n // 9,
            "R9_10": n // 10,
            "R1_4short": n * 4 // 5,  # LDPC r=1/5
            "R1_3short": n * 2 // 3,
            "R2_5short": n * 3 // 5,
            "R1_2short": n * 5 // 9,  # LDPC r=4/9
            "R3_5short": n * 2 // 5,
            "R2_3short": n // 3,
            # LDPC r=11/15, m = n*4/15 = 4320 per ETSI Table 5b (the
            # reference's dvbs2.rs:152 says n*14/15 — a typo inconsistent
            # with its own q=12 table and 33-row address table; the
            # standard-correct value is used here).
            "R3_4short": n * 4 // 15,
            "R4_5short": n * 2 // 9,  # LDPC r=7/9
            "R5_6short": n * 8 // 45,  # LDPC r=37/45
            "R8_9short": n // 9,
        }[self.name]

    @property
    def k(self) -> int:
        return self.n - self.m

    @property
    def q(self) -> int:
        return _DATA["q"][self.name]

    @property
    def addresses(self) -> list[list[int]]:
        """Annex B accumulator address table rows (one row per 360-column
        group of the systematic part)."""
        return _DATA["addresses"][self.name]

    def h(self) -> SparseMatrix:
        m = self.m
        q = self.q
        h = SparseMatrix(m, self.n)
        addresses = self.addresses
        for j in range(self.k):
            w = j % 360
            t = j // 360
            h.insert_col(j, ((x + w * q) % m for x in addresses[t]))
        # staircase parity part
        h.insert(0, self.k)
        for j in range(1, m):
            h.insert(j, j + self.k)
            h.insert(j, j + self.k - 1)
        return h
