"""BER test builder.

Counterpart of ``ldpc_toolbox_tpu.simulation.factory``
(src/simulation/factory.rs:44-108), for lifted and generic codes and BPSK;
8PSK waits for ROADMAP A9.
"""

from __future__ import annotations

from dataclasses import dataclass

from .ber import BerTest, BerTestParameters

__all__ = ["BerTestBuilder"]


@dataclass
class BerTestBuilder(BerTestParameters):
    """The parameters of a BER test, and ``build()`` to make it."""

    def build(self) -> BerTest:
        return BerTest(self)
