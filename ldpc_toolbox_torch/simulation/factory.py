"""BER test builder over the modulation registry.

Counterpart of ``ldpc_toolbox_tpu.simulation.factory`` (the reference's
``src/simulation/factory.rs``): the ``Modulation`` enum selects BPSK or
8PSK (factory.rs:56-73) and ``BerTestBuilder`` assembles a ``BerTest``
(factory.rs:44-108).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from .ber import BerTest, BerTestParameters
from .modulation import Bpsk, Psk8

__all__ = ["BerTestBuilder", "Modulation"]


class Modulation(Enum):
    BPSK = "BPSK"
    PSK8 = "8PSK"

    def instance(self):
        return Bpsk() if self is Modulation.BPSK else Psk8()

    @classmethod
    def parse(cls, s: str) -> "Modulation":
        for m in cls:
            if m.value == s:
                return m
        raise ValueError(f"invalid modulation {s!r}")


@dataclass
class BerTestBuilder(BerTestParameters):
    """The parameters of a BER test and its modulation, and ``build()`` to
    make it."""

    modulation: Modulation = Modulation.BPSK

    def build(self) -> BerTest:
        return BerTest(self, self.modulation.instance())
