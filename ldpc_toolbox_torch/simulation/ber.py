"""Monte-Carlo BER/FER simulation harness on torch tensors.

Counterpart of ``ldpc_toolbox_tpu.simulation.ber`` (the reference's
``src/simulation/ber.rs``). One step runs the whole per-frame chain over a
batch of frames on the test's device: random message, encode, BPSK, AWGN,
demodulate, decode, count systematic bit errors (ber.rs:436-481), and
returns nine counters. Each step draws its message and then its noise from
its own generator, seeded by (seed, point, step).

The decode is the lifted one when the parameters give the code's
``LiftedGraph``, else the generic parity-check decode of ``h``
(``decoder/flooding.py``, ``decoder/layered.py``). A code whose trailing
square is singular (CCSDS C2, a non-systematic alist) is encoded on
``encoder_h`` with its columns permuted by ``systematic_permutation`` and
sent in h's own column order; the message bits are then at ``perm[:k]``
(the JAX package's encode-side permutation).

Semantics kept from the reference:

* sigma = sqrt(0.5 / (rate * bits_per_symbol * 10^(EbN0/10))), rate = k/n
  (ber.rs:246-302);
* bit errors counted on systematic bits only (ber.rs:467-472);
* ``false_decode`` = decoder converged but wrong (ber.rs:474);
* stop rule per point: frame_errors >= max AND elapsed >= min_time, or
  elapsed >= max_time (ber.rs:522-531); with ``bch_max_errors`` the rule
  keys on the virtual BCH decoder's frame errors (ber.rs:514-520);
* throughput_mbps = 1e-6*k*frames/elapsed (ber.rs:550-582).

Not ported yet (ROADMAP A5, A9, A11): checkpoints, the live reporter,
puncturing, interleaving, 8PSK and sharding over several devices.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..decoder import DecodeGraph, generic_decode_for, lifted_decode_for
from ..decoder.factory import make_arithmetic
from ..encoder import Encoder
from ..sparse import SparseMatrix
from ..systematic import permute_columns
from .channel import AwgnChannel
from .modulation import Bpsk

__all__ = [
    "BerTest",
    "BerTestParameters",
    "CodeStatistics",
    "Statistics",
    "step_generator",
]


@dataclass
class CodeStatistics:
    """Per-code-layer statistics (ber.rs:168-189)."""

    bit_errors: int = 0
    frame_errors: int = 0
    correct_iterations: int = 0
    ber: float = 0.0
    fer: float = 0.0
    average_iterations_correct: float = 0.0


@dataclass
class Statistics:
    """Statistics for one Eb/N0 point (ber.rs:145-166)."""

    ebn0_db: float
    num_frames: int
    false_decodes: int
    total_iterations: int
    average_iterations: float
    elapsed: float  # seconds
    throughput_mbps: float
    ldpc: CodeStatistics
    bch: Optional[CodeStatistics] = None


@dataclass
class BerTestParameters:
    """Configuration of a BER test (BerTestParameters, ber.rs:60-96)."""

    h: SparseMatrix
    # the block-circulant layout of h (decoder.lifted.LiftedGraph); None:
    # the generic parity-check decode of h
    lifted_graph: Optional[object] = None
    decoder_implementation: str = "Phif64"
    max_frame_errors: int = 100
    min_run_time: Optional[float] = None  # seconds
    max_run_time: Optional[float] = None
    max_iterations: int = 100
    ebn0s_db: Sequence[float] = field(default_factory=list)
    bch_max_errors: int = 0
    # frames per decode step
    batch_size: int = 128
    seed: int = 0
    device: str = "cuda"
    # column permutation to a systematic-encodable form
    # (systematic.systematic_permutation): encoding happens on
    # encoder_h[:, perm], whose trailing square is invertible, the channel
    # and the decoder run in h's column order, and bit errors are counted
    # on the message positions perm[:k]
    systematic_permutation: Optional[object] = None
    # a full-rank matrix with h's null space (systematic.full_rank_rows),
    # for a rank-deficient h such as CCSDS C2's (1022 rows, rank 1020):
    # k = n - its rows; the decoder keeps h's redundant checks
    encoder_h: Optional[SparseMatrix] = None
    # an Encoder already built for encoder_h (or h), on the test's device
    prebuilt_encoder: Optional[object] = None


@dataclass
class _Counters:
    num_frames: int = 0
    bit_errors: int = 0
    frame_errors: int = 0
    false_decodes: int = 0
    total_iterations: int = 0
    correct_iterations: int = 0
    bch_bit_errors: int = 0
    bch_frame_errors: int = 0
    bch_correct_iterations: int = 0

    def add(self, d: dict) -> None:
        for name, value in d.items():
            setattr(self, name, getattr(self, name) + int(value))


_COUNTER_NAMES = tuple(f.name for f in dataclasses.fields(_Counters))


def step_generator(seed: int, point: int, step: int, device) -> torch.Generator:
    """The generator of one simulation step, seeded from
    ``SeedSequence([seed, point, step])``: like the JAX harness's key folded
    by (point, step), every step's stream depends only on those three."""
    state = np.random.SeedSequence([seed, point, step]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & (2**63 - 1))
    return gen


def _frame_counters(msg, out, bch_max_errors: int, msg_cols=None) -> dict:
    """The step's nine counters from the messages and the decoder output,
    as Python ints (one copy from the device); the message bits are the
    codeword's first k, or its columns ``msg_cols``."""
    k = msg.shape[1]
    sys_bits = out["codeword"][:, :k] if msg_cols is None else out["codeword"][:, msg_cols]
    errbits = (sys_bits != msg).sum(dim=1, dtype=torch.int32)
    frame_err = errbits > 0
    iters = out["iterations"]
    bch_frame_err = errbits > bch_max_errors
    zero = torch.zeros_like(iters)
    values = torch.stack([
        torch.tensor(msg.shape[0], dtype=torch.int64, device=msg.device),
        errbits.sum(dtype=torch.int64),
        frame_err.sum(dtype=torch.int64),
        (frame_err & out["success"]).sum(dtype=torch.int64),
        iters.sum(dtype=torch.int64),
        torch.where(frame_err, zero, iters).sum(dtype=torch.int64),
        torch.where(bch_frame_err, errbits, zero).sum(dtype=torch.int64),
        bch_frame_err.sum(dtype=torch.int64),
        torch.where(bch_frame_err, zero, iters).sum(dtype=torch.int64),
    ]).tolist()
    return dict(zip(_COUNTER_NAMES, values))


class BerTest:
    """BER test over a list of Eb/N0 points, BPSK, lifted or generic decode
    (flooding or layered, as the decoder name says)."""

    def __init__(self, parameters: BerTestParameters):
        p = parameters
        self.p = p
        self.modulation = Bpsk()
        self.device = torch.device(p.device)
        enc_h = p.encoder_h if p.encoder_h is not None else p.h
        self.k = p.h.num_cols - enc_h.num_rows
        self.n = p.h.num_cols
        self.rate = self.k / self.n
        self._enc_unperm = self._msg_cols = None
        if p.systematic_permutation is not None:
            perm = np.asarray(p.systematic_permutation, np.int64)
            self.encoder = Encoder(permute_columns(enc_h, perm), device=self.device)
            # the permuted codeword back to h's column order, and where
            # the message bits are there
            self._enc_unperm = torch.as_tensor(np.argsort(perm), device=self.device)
            self._msg_cols = torch.as_tensor(perm[: self.k], device=self.device)
        elif p.prebuilt_encoder is not None:
            self.encoder = p.prebuilt_encoder
        else:
            self.encoder = Encoder(enc_h, device=self.device)
        self.schedule, self.arithmetic = make_arithmetic(
            p.decoder_implementation
        )
        if p.lifted_graph is None:
            self.graph = DecodeGraph.from_sparse(p.h)
            self.decode = generic_decode_for(self.schedule)
        else:
            self.graph = p.lifted_graph
            self.decode = lifted_decode_for(self.schedule)
        self.statistics: list[Statistics] = []

    def encode(self, msg: torch.Tensor) -> torch.Tensor:
        """(B, k) messages -> (B, n) codewords in h's column order."""
        cw = self.encoder.encode_batch(msg)
        return cw if self._enc_unperm is None else cw[:, self._enc_unperm]

    def step(self, generator: torch.Generator, noise_sigma: float) -> dict:
        """One batch of frames through the whole chain; its nine counters."""
        p = self.p
        msg = torch.randint(
            0, 2, (p.batch_size, self.k), generator=generator,
            dtype=torch.uint8, device=self.device,
        )
        sym = self.modulation.modulate(self.encode(msg))
        rx = AwgnChannel.add_noise(sym, noise_sigma, generator)
        llr = self.modulation.demodulate(rx, noise_sigma)
        out = self.decode(self.graph, self.arithmetic, llr, p.max_iterations)
        return _frame_counters(msg, out, p.bch_max_errors, self._msg_cols)

    def _point_statistics(
        self, c: _Counters, ebn0_db: float, elapsed: float
    ) -> Statistics:
        nf = max(c.num_frames, 1)
        ldpc = CodeStatistics(
            bit_errors=c.bit_errors,
            frame_errors=c.frame_errors,
            correct_iterations=c.correct_iterations,
            ber=c.bit_errors / (self.k * nf),
            fer=c.frame_errors / nf,
            average_iterations_correct=(
                c.correct_iterations / max(nf - c.frame_errors, 1)
            ),
        )
        bch = None
        if self.p.bch_max_errors > 0:
            bch = CodeStatistics(
                bit_errors=c.bch_bit_errors,
                frame_errors=c.bch_frame_errors,
                correct_iterations=c.bch_correct_iterations,
                ber=c.bch_bit_errors / (self.k * nf),
                fer=c.bch_frame_errors / nf,
                average_iterations_correct=(
                    c.bch_correct_iterations / max(nf - c.bch_frame_errors, 1)
                ),
            )
        return Statistics(
            ebn0_db=ebn0_db,
            num_frames=c.num_frames,
            false_decodes=c.false_decodes,
            total_iterations=c.total_iterations,
            average_iterations=c.total_iterations / nf,
            elapsed=elapsed,
            throughput_mbps=1e-6 * self.k * c.num_frames / max(elapsed, 1e-12),
            ldpc=ldpc,
            bch=bch,
        )

    def run(self) -> list[Statistics]:
        p = self.p
        min_time = p.min_run_time or 0.0
        max_time = p.max_run_time if p.max_run_time is not None else float("inf")
        for point, ebn0_db in enumerate(p.ebn0s_db):
            ebn0 = 10.0 ** (0.1 * float(ebn0_db))
            esn0 = self.rate * self.modulation.BITS_PER_SYMBOL * ebn0
            noise_sigma = float(np.sqrt(0.5 / esn0))
            counters = _Counters()
            step_idx = 0
            start = time.monotonic()
            while True:
                elapsed = time.monotonic() - start
                errors = (
                    counters.bch_frame_errors
                    if p.bch_max_errors > 0
                    else counters.frame_errors
                )
                if (
                    errors >= p.max_frame_errors and elapsed >= min_time
                ) or elapsed >= max_time:
                    break
                gen = step_generator(p.seed, point, step_idx, self.device)
                counters.add(self.step(gen, noise_sigma))
                step_idx += 1
            self.statistics.append(
                self._point_statistics(
                    counters, ebn0_db, time.monotonic() - start
                )
            )
        return self.statistics
