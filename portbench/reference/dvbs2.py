"""DVB-S2 LDPC codes (ETSI EN 302 307-1 §5.3.2), in numpy.

The parity-check matrix of §5.3.2.1: systematic column ``j`` has a one in
row ``(x + (j mod 360) q) mod m`` for each accumulator address ``x`` of
the table row ``j // 360`` (Annex B for normal frames, Annex C for short
ones); the parity part is the staircase: row 0 holds column ``k``, row
``r >= 1`` columns ``k + r - 1`` and ``k + r``.

``dvbs2_tables.json`` beside this file is a frozen copy of the tables of
the codes the benchmark runs (rates 1/2 and 3/5, normal and short).

The code is a 360-lift: row ``a + b q`` lies in check group ``a`` at lane
``b``, systematic column ``j`` in variable group ``j // 360`` at lane
``j mod 360``, parity column ``k + a + b q`` in variable group
``k / 360 + a`` at lane ``b``. An edge between check lane ``lc`` and
variable lane ``lv`` has the shift ``(lc - lv) mod 360``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["Z", "Dvbs2Code", "code"]

Z = 360

#: the check rows of each (rate, short frame) (EN 302 307-1 Tables 5a, 5b)
_ROWS = {
    ("1/2", False): 32400,
    ("3/5", False): 25920,
    ("1/2", True): 9000,
    ("3/5", True): 6480,
}


@dataclass(frozen=True)
class Dvbs2Code:
    name: str  # the table's name, e.g. "R1_2" or "R3_5short"
    n: int
    m: int
    q: int
    addresses: tuple  # of tuples of ints, one a 360-column group

    @property
    def Z(self) -> int:
        return Z

    @property
    def k(self) -> int:
        return self.n - self.m

    def edges(self):
        """(rows, cols) int64 arrays of H's ones, sorted by row, then
        column."""
        rows, cols = [], []
        w = np.arange(Z, dtype=np.int64)
        for t, xs in enumerate(self.addresses):
            for x in xs:
                rows.append((x + w * self.q) % self.m)
                cols.append(t * Z + w)
        rows.append(np.arange(self.m, dtype=np.int64))
        cols.append(self.k + np.arange(self.m, dtype=np.int64))
        rows.append(np.arange(1, self.m, dtype=np.int64))
        cols.append(self.k + np.arange(self.m - 1, dtype=np.int64))
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        order = np.lexsort((c, r))
        return r[order], c[order]

    def check_lift(self, rows):
        """(group, lane) of each row."""
        return rows % self.q, rows // self.q

    def var_lift(self, cols):
        """(group, lane) of each column."""
        info = cols < self.k
        p = cols - self.k
        group = np.where(info, cols // Z, self.k // Z + p % self.q)
        lane = np.where(info, cols % Z, p // self.q)
        return group, lane


def code(spec: str) -> Dvbs2Code:
    """The code of a ``dvbs2:RATE`` or ``dvbs2:RATE:short`` spec."""
    parts = spec.split(":")
    if parts[0] != "dvbs2" or len(parts) not in (2, 3) or parts[2:] not in ([], ["short"]):
        raise ValueError(f"not a DVB-S2 code spec: {spec!r}")
    short = len(parts) == 3
    rate = parts[1]
    name = "R" + rate.replace("/", "_") + ("short" if short else "")
    tables = json.loads((Path(__file__).parent / "dvbs2_tables.json").read_text())
    if name not in tables or (rate, short) not in _ROWS:
        raise ValueError(f"no frozen table for {spec!r}")
    t = tables[name]
    return Dvbs2Code(
        name=name,
        n=16200 if short else 64800,
        m=_ROWS[(rate, short)],
        q=int(t["q"]),
        addresses=tuple(tuple(int(x) for x in row) for row in t["addresses"]),
    )
