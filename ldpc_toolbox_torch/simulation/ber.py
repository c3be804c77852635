"""Monte-Carlo BER/FER simulation harness on torch tensors.

Counterpart of ``ldpc_toolbox_tpu.simulation.ber`` (the reference's
``src/simulation/ber.rs``). One step runs the whole per-frame chain over a
batch of frames on the test's device: random message, encode, puncture,
interleave, modulate (BPSK or 8PSK), AWGN, demodulate, deinterleave,
depuncture, decode, count systematic bit errors (ber.rs:436-481), and
returns nine counters. Each step draws its message and then its noise from
its own generator, seeded by (seed, point, step), and its counters are
read as it ends; so a sweep resumed from a checkpoint gives the counters
of an uninterrupted one.

The decode is the lifted one when the parameters give the code's
``LiftedGraph``, else the generic parity-check decode of ``h``
(``decoder/flooding.py``, ``decoder/layered.py``). A code whose trailing
square is singular (CCSDS C2, a non-systematic alist) is encoded on
``encoder_h`` with its columns permuted by ``systematic_permutation`` and
sent in h's own column order; the message bits are then at ``perm[:k]``
(the JAX package's encode-side permutation).

Semantics kept from the reference:

* sigma = sqrt(0.5 / (rate * bits_per_symbol * 10^(EbN0/10))), with
  rate = k/n after puncturing (ber.rs:246-302);
* bit errors counted on systematic bits only (ber.rs:467-472);
* ``false_decode`` = decoder converged but wrong (ber.rs:474);
* stop rule per point: frame_errors >= max AND elapsed >= min_time, or
  elapsed >= max_time (ber.rs:522-531); with ``bch_max_errors`` the rule
  keys on the virtual BCH decoder's frame errors (ber.rs:514-520);
* throughput_mbps = 1e-6*k*frames/elapsed (ber.rs:550-582);
* a ``reporter(stats, final)`` called every ``report_interval`` seconds
  and once as each point ends; with ``checkpoint_path`` the sweep's state
  is saved as often and after every point, in the JAX package's JSON
  format, and resumed from there; on Ctrl-C the point's partial state is
  saved and the interrupt raised again.

With a ``mesh`` (``parallel.mesh.Mesh``, one rank a device) the batch is
sharded over the ranks: every rank draws the whole batch's message and
noise from the step's generator, so the Monte-Carlo stream does not
depend on the number of ranks, then decodes and counts its own rows
(``shard_batch``); the counters are summed over the ranks before they are
read, and the stop rule reads the largest of the ranks' clocks, so every
rank stops after the same step. Each rank writes the checkpoint it is
given and calls a reporter only where it is given one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..decoder import DecodeGraph, generic_decode_for, lifted_decode_for
from ..decoder.factory import make_arithmetic
from ..encoder import Encoder
from ..parallel.mesh import max_over, shard_batch, sum_over
from ..sparse import SparseMatrix
from ..systematic import permute_columns
from .channel import AwgnChannel
from .interleaving import Interleaver
from .modulation import Bpsk
from .puncturing import Puncturer

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
    puncturing_pattern: Optional[Sequence[bool]] = None
    # abs value = columns; negative = read rows backwards (ber.rs:66-70)
    interleaving_columns: Optional[int] = None
    max_frame_errors: int = 100
    min_run_time: Optional[float] = None  # seconds
    max_run_time: Optional[float] = None
    max_iterations: int = 100
    ebn0s_db: Sequence[float] = field(default_factory=list)
    # reporter(stats, final) called every >= report_interval and per point
    reporter: Optional[Callable[[Statistics, bool], None]] = None
    report_interval: float = 0.5
    bch_max_errors: int = 0
    # frames per decode step
    batch_size: int = 128
    seed: int = 0
    device: str = "cuda"
    # checkpoint file: the sweep's state is saved after every point (and
    # every report_interval within one), so a long sweep resumes
    checkpoint_path: Optional[str] = None
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
    # parallel.mesh.Mesh: shard each step's batch over the ranks (the
    # device stays ``device``: give each rank its mesh.device)
    mesh: Optional[object] = None


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


def _frame_counters(msg, out, bch_max_errors: int, msg_cols=None, mesh=None) -> dict:
    """The step's nine counters from the messages and the decoder output,
    as Python ints (one copy from the device), summed over the ranks of
    ``mesh`` when given; the message bits are the codeword's first k, or
    its columns ``msg_cols``."""
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
    ])
    if mesh is not None:
        values = sum_over(mesh, values)
    return dict(zip(_COUNTER_NAMES, values.tolist()))


class BerTest:
    """BER test over a list of Eb/N0 points, BPSK or 8PSK, lifted or generic
    decode (flooding or layered, as the decoder name says)."""

    def __init__(self, parameters: BerTestParameters, modulation=None):
        p = parameters
        self.p = p
        self.modulation = modulation if modulation is not None else Bpsk()
        self.device = torch.device(p.device)
        enc_h = p.encoder_h if p.encoder_h is not None else p.h
        self.k = p.h.num_cols - enc_h.num_rows
        self.n_cw = p.h.num_cols
        self.puncturer = (
            Puncturer(p.puncturing_pattern) if p.puncturing_pattern else None
        )
        self.interleaver = (
            Interleaver(abs(p.interleaving_columns), p.interleaving_columns < 0)
            if p.interleaving_columns
            else None
        )
        punct_rate = self.puncturer.rate() if self.puncturer else 1.0
        self.n = round(self.n_cw / punct_rate)
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
        if p.mesh is not None and p.batch_size % p.mesh.size:
            raise ValueError(
                f"batch size {p.batch_size} does not split over {p.mesh.size} ranks"
            )
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
        """(B, k) messages -> (B, n_cw) codewords in h's column order."""
        cw = self.encoder.encode_batch(msg)
        return cw if self._enc_unperm is None else cw[:, self._enc_unperm]

    def channel_llrs(self, cw: torch.Tensor, noise_sigma: float,
                     generator: torch.Generator) -> torch.Tensor:
        """(B, n_cw) codewords -> (B, n_cw) decoder LLRs: puncture,
        interleave, modulate, AWGN from ``generator``, demodulate,
        deinterleave, depuncture (zero LLRs at the punctured bits)."""
        tx = self.puncturer.puncture(cw) if self.puncturer else cw
        tx = self.interleaver.interleave(tx) if self.interleaver else tx
        sym = self.modulation.modulate(tx)
        rx = AwgnChannel.add_noise(sym, noise_sigma, generator)
        llr = self.modulation.demodulate(rx, noise_sigma)
        llr = self.interleaver.deinterleave(llr) if self.interleaver else llr
        return self.puncturer.depuncture(llr) if self.puncturer else llr

    def step(self, generator: torch.Generator, noise_sigma: float) -> dict:
        """One batch of frames through the whole chain; its nine counters
        (with a mesh: this rank's rows decoded, the counters summed over
        the ranks)."""
        p = self.p
        msg = torch.randint(
            0, 2, (p.batch_size, self.k), generator=generator,
            dtype=torch.uint8, device=self.device,
        )
        llr = self.channel_llrs(self.encode(msg), noise_sigma, generator)
        if p.mesh is not None:
            msg, llr = shard_batch(msg, p.mesh), shard_batch(llr, p.mesh)
        out = self.decode(self.graph, self.arithmetic, llr, p.max_iterations)
        return _frame_counters(msg, out, p.bch_max_errors, self._msg_cols, p.mesh)

    def noise_sigma(self, ebn0_db: float) -> float:
        """The channel's sigma at an Eb/N0 (ber.rs:246-302)."""
        ebn0 = 10.0 ** (0.1 * float(ebn0_db))
        esn0 = self.rate * self.modulation.BITS_PER_SYMBOL * ebn0
        return float(np.sqrt(0.5 / esn0))

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

    # -- sweep checkpoints: the JAX package's format and rules -------------

    def _checkpoint_state(self, point, counters, step_idx, point_elapsed):
        return {
            "version": 1,
            "seed": self.p.seed,
            "ebn0s_db": [float(e) for e in self.p.ebn0s_db],
            "decoder": self.p.decoder_implementation,
            "completed": [dataclasses.asdict(s) for s in self.statistics],
            "point": point,
            "counters": dataclasses.asdict(counters),
            "step_idx": step_idx,
            "point_elapsed": point_elapsed,
        }

    def _save_checkpoint(self, state) -> None:
        tmp = self.p.checkpoint_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.p.checkpoint_path)

    def _load_checkpoint(self):
        """The saved state, its completed points appended to
        ``statistics``; None when there is none or it was saved for another
        seed, Eb/N0 list or decoder (the sweep then starts afresh)."""
        path = self.p.checkpoint_path
        if not path or not os.path.exists(path):
            return None
        with open(path) as f:
            state = json.load(f)
        if (
            state.get("version") != 1
            or state.get("seed") != self.p.seed
            or state.get("ebn0s_db") != [float(e) for e in self.p.ebn0s_db]
            or state.get("decoder") != self.p.decoder_implementation
        ):
            return None
        for s in state["completed"]:
            ldpc = CodeStatistics(**s.pop("ldpc"))
            bch = s.pop("bch")
            self.statistics.append(
                Statistics(
                    **s, ldpc=ldpc, bch=CodeStatistics(**bch) if bch else None
                )
            )
        return state

    def run(self) -> list[Statistics]:
        p = self.p
        min_time = p.min_run_time or 0.0
        max_time = p.max_run_time if p.max_run_time is not None else float("inf")
        resume = self._load_checkpoint()
        start_point = resume["point"] if resume is not None else 0
        for point, ebn0_db in enumerate(p.ebn0s_db):
            if point < start_point:
                continue  # restored from the checkpoint
            noise_sigma = self.noise_sigma(ebn0_db)
            if point == start_point and resume is not None:
                counters = _Counters(**resume["counters"])
                step_idx = resume["step_idx"]
                start = time.monotonic() - resume["point_elapsed"]
            else:
                counters = _Counters()
                step_idx = 0
                start = time.monotonic()
            last_report = time.monotonic()
            try:
                while True:
                    elapsed = time.monotonic() - start
                    if p.mesh is not None:  # every rank decides alike
                        elapsed = max_over(p.mesh, elapsed)
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
                    now = time.monotonic()
                    if now - last_report >= p.report_interval:
                        last_report = now
                        if p.reporter is not None:
                            p.reporter(
                                self._point_statistics(counters, ebn0_db, now - start),
                                False,
                            )
                        if p.checkpoint_path:
                            self._save_checkpoint(self._checkpoint_state(
                                point, counters, step_idx, now - start))
            except KeyboardInterrupt:
                # graceful Ctrl-C (reference cli/ber.rs:254-261): leave a
                # resumable checkpoint of the steps done, then unwind
                if p.checkpoint_path:
                    self._save_checkpoint(self._checkpoint_state(
                        point, counters, step_idx, time.monotonic() - start))
                raise
            stats = self._point_statistics(
                counters, ebn0_db, time.monotonic() - start
            )
            self.statistics.append(stats)
            if p.reporter is not None:
                p.reporter(stats, True)
            if p.checkpoint_path:
                self._save_checkpoint(
                    self._checkpoint_state(point + 1, _Counters(), 0, 0.0)
                )
        return self.statistics
