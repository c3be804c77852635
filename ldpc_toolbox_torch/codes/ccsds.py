"""CCSDS TM Synchronization and Channel Coding LDPC codes.

AR4JA protograph codes (rates 1/2, 2/3, 4/5 at k = 1024/4096/16384) and the
C2 code (nominally (8176, 7154); its 1022-row H has rank 1020, so the
true dimension is 7156 — ccsds.rs:340), per CCSDS 131.0-B-5. Capability parity with the
reference's ``src/codes/ccsds.rs`` (H layout ccsds.rs:51-144, permutation
pi ccsds.rs:176-188, C2 circulant grid ccsds.rs:353-372). The THETA/PHI and
circulant constants (Tables 7-3/7-4/7-1 of the standard) load from
``data/ccsds_tables.json``.

A copy of ``ldpc_toolbox_tpu.codes.ccsds``, kept so that this package imports
nothing of the JAX package; ``tests/test_torch_layout.py`` holds the two
equal.
"""

from __future__ import annotations

import json
import pathlib
from enum import Enum

from ..sparse import SparseMatrix

__all__ = ["AR4JARate", "AR4JAInfoSize", "AR4JACode", "C2Code"]

_DATA = json.loads(
    (pathlib.Path(__file__).parent / "data/ccsds_tables.json").read_text()
)
_THETA_K: list[int] = _DATA["theta_k"]
_PHI_K: list[list[list[int]]] = _DATA["phi_k"]  # [j][k-1][log2(M)-7]
_C2_CIRCULANTS: list[list[list[int]]] = _DATA["c2_circulants"]


class AR4JARate(Enum):
    R1_2 = "1/2"
    R2_3 = "2/3"
    R4_5 = "4/5"


class AR4JAInfoSize(Enum):
    K1024 = 1024
    K4096 = 4096
    K16384 = 16384


# Table 7-2 of CCSDS 131.0-B-5: submatrix size M per (rate, k)
_M_TABLE = {
    (AR4JARate.R1_2, AR4JAInfoSize.K1024): 512,
    (AR4JARate.R2_3, AR4JAInfoSize.K1024): 256,
    (AR4JARate.R4_5, AR4JAInfoSize.K1024): 128,
    (AR4JARate.R1_2, AR4JAInfoSize.K4096): 2048,
    (AR4JARate.R2_3, AR4JAInfoSize.K4096): 1024,
    (AR4JARate.R4_5, AR4JAInfoSize.K4096): 512,
    (AR4JARate.R1_2, AR4JAInfoSize.K16384): 8192,
    (AR4JARate.R2_3, AR4JAInfoSize.K16384): 4096,
    (AR4JARate.R4_5, AR4JAInfoSize.K16384): 2048,
}


class AR4JACode:
    """AR4JA code definition (ccsds.rs:14-48)."""

    def __init__(self, rate: AR4JARate, information_block_size: AR4JAInfoSize):
        self.rate = rate
        self.k = information_block_size
        self.m_size = _M_TABLE[(rate, information_block_size)]

    def theta(self, k: int) -> int:
        assert 1 <= k <= 26
        return _THETA_K[k - 1]

    def phi(self, k: int, j: int) -> int:
        assert 1 <= k <= 26 and 0 <= j < 4
        m_index = self.m_size.bit_length() - 1 - 7  # log2(M) - log2(128)
        return _PHI_K[j][k - 1][m_index]

    def pi(self, k: int, i: int) -> int:
        """Permutation pi_k(i) per CCSDS 131.0-B-5 section 7.4.2.4."""
        m = self.m_size
        j = 4 * i // m
        return (m // 4) * ((self.theta(k) + j) % 4) + (self.phi(k, j) + i) % (m // 4)

    def h(self) -> SparseMatrix:
        """Parity check matrix: 3M x (5M + extra) protograph expansion
        (ccsds.rs:51-144). Note H includes the M punctured columns at the
        end (block column 4)."""
        m = self.m_size
        extra_blocks = {AR4JARate.R1_2: 0, AR4JARate.R2_3: 2, AR4JARate.R4_5: 6}[
            self.rate
        ]
        ec = m * extra_blocks
        h = SparseMatrix(3 * m, ec + 5 * m)

        pi = self.pi
        for i in range(m):
            # common H_1/2 part
            h.insert(i, ec + 2 * m + i)  # block(0,2) = I
            h.insert(i, ec + 4 * m + i)  # block(0,4) = I + Pi_1
            h.toggle(i, ec + 4 * m + pi(1, i))
            h.insert(m + i, ec + i)  # block(1,0) = I
            h.insert(m + i, ec + m + i)  # block(1,1) = I
            h.insert(m + i, ec + 3 * m + i)  # block(1,3) = I
            h.insert(m + i, ec + 4 * m + pi(2, i))  # block(1,4)=Pi2+Pi3+Pi4
            h.toggle(m + i, ec + 4 * m + pi(3, i))
            h.toggle(m + i, ec + 4 * m + pi(4, i))
            h.insert(2 * m + i, ec + i)  # block(2,0) = I
            h.insert(2 * m + i, ec + m + pi(5, i))  # block(2,1)=Pi5+Pi6
            h.toggle(2 * m + i, ec + m + pi(6, i))
            h.insert(2 * m + i, ec + 3 * m + pi(7, i))  # block(2,3)=Pi7+Pi8
            h.toggle(2 * m + i, ec + 3 * m + pi(8, i))
            h.insert(2 * m + i, ec + 4 * m + i)  # block(2,4) = I

        if self.rate is not AR4JARate.R1_2:
            # H_2/3 extension occupies the two blocks before the common part
            ec23 = {AR4JARate.R2_3: 0, AR4JARate.R4_5: 4 * m}[self.rate]
            for i in range(m):
                h.insert(m + i, ec23 + pi(9, i))
                h.toggle(m + i, ec23 + pi(10, i))
                h.toggle(m + i, ec23 + pi(11, i))
                h.insert(m + i, ec23 + m + i)
                h.insert(2 * m + i, ec23 + i)
                h.insert(2 * m + i, ec23 + m + pi(12, i))
                h.toggle(2 * m + i, ec23 + m + pi(13, i))
                h.toggle(2 * m + i, ec23 + m + pi(14, i))

        if self.rate is AR4JARate.R4_5:
            for i in range(m):
                h.insert(m + i, pi(21, i))
                h.toggle(m + i, pi(22, i))
                h.toggle(m + i, pi(23, i))
                h.insert(m + i, m + i)
                h.insert(m + i, 2 * m + pi(15, i))
                h.toggle(m + i, 2 * m + pi(16, i))
                h.toggle(m + i, 2 * m + pi(17, i))
                h.insert(m + i, 3 * m + i)
                h.insert(2 * m + i, i)
                h.insert(2 * m + i, m + pi(24, i))
                h.toggle(2 * m + i, m + pi(25, i))
                h.toggle(2 * m + i, m + pi(26, i))
                h.insert(2 * m + i, 2 * m + i)
                h.insert(2 * m + i, 3 * m + pi(18, i))
                h.toggle(2 * m + i, 3 * m + pi(19, i))
                h.toggle(2 * m + i, 3 * m + pi(20, i))

        return h


class C2Code:
    """Basic C2 LDPC code — nominally (8176, 7154), truly (8176, 7156)
    (H rank 1020) — a 2x16 grid of 511x511 weight-2 circulants
    (ccsds.rs:344-372; Table 7-1 of CCSDS 131.0-B-5)."""

    N = 511
    ROW_BLOCKS = 2
    COL_BLOCKS = 16

    def h(self) -> SparseMatrix:
        n = self.N
        h = SparseMatrix(self.ROW_BLOCKS * n, self.COL_BLOCKS * n)
        for row, row_circs in enumerate(_C2_CIRCULANTS):
            for col, circs in enumerate(row_circs):
                for circ in circs:
                    for j in range(n):
                        h.insert(row * n + j, col * n + (j + circ) % n)
        return h
