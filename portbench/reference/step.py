"""The reference side of a ``ber`` step: the inputs drawn from the step's
generator, the decode, the counters, and the control.

A configuration names its parts by module (``reference`` in its file):
``code`` a module of this package with ``code(spec)`` (``dvbs2``),
``decoder`` one with ``<schedule>_decode(graph, llr, max_iterations,
storage)`` (``minsum``), and the message ``storage`` type. The control
is the reference put in the program's place one precision lower
(``LOWER``): a bfloat16 channel in place of float32, and the messages a
step below their ``storage``.

``step_generator`` is the reference's own copy of the port's seeding of a
``ber`` step, so that a change to the port's seeding shows as not correct.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from . import channel
from .counters import step_counters
from .encode import staircase_encode
from .graph import build_graph

__all__ = ["LOWER", "ReferenceStep", "step_generator"]

#: the nearest precision below a type, the control's
LOWER = {
    torch.float64: torch.float32,
    torch.float32: torch.bfloat16,
    torch.bfloat16: torch.float8_e4m3fn,
    torch.float16: torch.float8_e4m3fn,
}


def step_generator(seed: int, point: int, step: int, device) -> torch.Generator:
    """The generator of one step, seeded from ``SeedSequence([seed, point,
    step])`` as the port's ``ber`` seeds its steps."""
    state = np.random.SeedSequence([seed, point, step]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & (2**63 - 1))
    return gen


def _part(name):
    return importlib.import_module(f"{__package__}.{name}")


class ReferenceStep:
    def __init__(self, config, device):
        ref = config["reference"]
        self.config = config
        self.device = torch.device(device)
        self.code = _part(ref["code"]).code(config["code"])
        self.graph = build_graph(self.code)
        self.decoder = getattr(_part(ref["decoder"]), f"{ref['schedule']}_decode")
        self.storage = getattr(torch, ref["storage"])

    @property
    def rate(self):
        return self.code.k / self.code.n

    def sigma(self, ebn0_db):
        return channel.sigma(ebn0_db, self.rate, self.config["modulation"])

    def inputs(self, generator, ebn0_db, channel_dtype=torch.float32):
        """(msg, cw, llr) of a step drawn from ``generator``."""
        B, k = self.config["batch_size"], self.code.k
        msg = torch.randint(0, 2, (B, k), generator=generator, dtype=torch.uint8,
                            device=self.device)
        cw = staircase_encode(self.code, msg)
        llr = channel.llrs(cw, self.sigma(ebn0_db), self.config["modulation"], generator,
                           self.config.get("interleaving"), channel_dtype)
        return msg, cw, llr

    def decode(self, llr, storage=None):
        return self.decoder(self.graph, llr, self.config["max_iter"], storage or self.storage)

    def counters(self, msg, out):
        return step_counters(msg, out["codeword"], out["iterations"], out["success"])

    def control(self, generator, ebn0_db):
        """What the control puts in the program's place for a step: the
        step's answers with the channel and the messages one precision
        lower, in the shape the harness keeps of the program's."""
        msg, cw, llr = self.inputs(generator, ebn0_db, LOWER[torch.float32])
        out = self.decode(llr, LOWER[self.storage])
        return {"msg": msg, "cw": cw, "llr": llr, "out": out,
                "counters": self.counters(msg, out)}
