"""Smoke run of ldpc_toolbox_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout's sources (one nvcc a source,
all at once), holds the i8 rules' word steps against the plain rules on
every byte pair in [0, 127]^2, holds every kernel bit for bit against its
plain PyTorch version (5G BG2 z=16, DVB-S2 R1_4short and R1_2, CCSDS C2; three min-sum
names each, and the normalized f32 names for the compressed kernels; two
i8 names a schedule for the int8 instances of the message kernels, with
large-magnitude frames on 5G BG2 z=16; CCSDS AR4JA K=1024 rates 1/2 and
4/5 and 5G BG1 z=16 for the resident kernels; batches of 130 for the
partial tile; a quasi-cyclic code of check degree 40 for the f32 flooding
instances' 64 bucket), and drives the port's main paths on the flagship code
(DVB-S2 rate 1/2, n = 64800, B = 1024, 1.0 dB, at most 30 iterations):

1. the layered decode through ``Decoder(Code.R1_2, "HLMinsumbf16")``;
2. the flooding decode through ``Decoder(Code.R1_2, "Minsumbf16")`` (the
   resident kernel), and the same decode on the streaming path
   (``lifted_flooding_decode(..., resident=False)``, the phase kernels);
3. (a) ``Decoder(Code.R1_2, "HLMinsumf32")``, the compressed layered
   kernel; (b) ``Decoder(Code.R1_2, "Minsumf32")``, the compressed
   flooding kernel; (c) ``lifted_layered_decode(..., resident=False)`` on
   ``HLMinsumbf16``, the streaming layered sweep under staged compaction;
4. the i8 decodes ``Decoder(Code.R1_2, "HLMinstarapproxi8")`` and
   ``Decoder(Code.R1_2, "Minstarapproxi8")``, the int8 instances of the
   two message kernels;
5. the float decodes ``Decoder(Code.R1_2)`` (no name: the reference's
   default, ``Phif64``, flooding), ``Decoder(Code.R1_2, "HLPhif32")`` and
   ``Decoder(Code.R1_2, "Phif32")`` (the f32 flooding instances, whose
   thread map is their own: a line of their own in the kernels JSON), the
   float-rule instances of the two message kernels (all 16 float names
   held against the plain versions on the test codes first, R1_2 at 8
   iterations);
6. the streaming decodes (``resident=False``) of ``Phif64``, ``Phif32``
   and ``Minstarapproxi8`` (flooding: the i8 and float instances of the
   check and variable phases) and of ``HLPhif32`` and ``HLMinstarapproxi8``
   (layered: those of the sweep), each equal to the resident decode of its
   name (the i8 and float streaming instances held against their plain
   versions on the test codes first, all 16 float names and two i8 names a
   schedule); and ``HLPhif64``'s, its sweeps counted, timed in turns with
   its resident decode (the kernels line keeps ``HLPhif32``'s sweep);

7. the generic parity-check path (``decoder/flooding.py``,
   ``decoder/layered.py``: torch ops, no kernel of the nine, and the
   counts show it): flooding ``Decoder(h)`` (``Phif64``) and
   ``Decoder(h, "Minsumf32")`` on DVB-S2 R1_2's H beside the lifted
   decodes of the same names, layered ``HLMinsumf32`` and
   ``HLMinstarapproxi8`` on ``results/bench_5g_bg1_384.alist`` (5G BG1
   Z=384, B = 1024, 1.0 dB), the first 1000 layers of a layered sweep of
   DVB-S2 R1_2short (a layer a check) timed, the card against the CPU on
   5G BG2 z=16, AR4JA K1024 R1_2 and the MacKay-Neal alist (min-sum and
   i8 names bit for bit, float names on at least 63 of 64 frames), and the
   port's ``ber`` on the
   MacKay-Neal alists at 1.5 and 2.0 dB against the recorded FER rows of
   ``results/config{1,2}_*.txt`` (two-proportion |z| <= 3.29; the
   non-systematic alist through the encode-side permutation) and on
   ``ccsds-c2`` (FER >= 0.5 at 3.6 dB, <= 0.01 at 4.2 dB);
8. the rest of ``ber``, through the port's command line: the DVB-S2 8PSK
   r=3/5 pipeline of RESULTS.md (``ber dvbs2:3/5 --modulation 8PSK
   --interleaving -3 --decoder Minsumbf16``, B = 256: the flooding bf16
   kernel at bucket 16), its FER at 3.6, 3.7 and 3.8 dB held against the
   JAX package's rows (tests/torch_parity.py, |z| <= 3.29), its Mbit/s at
   4.5 dB for 2 s at B = 256 and 1024; config 3 of tools/run_results.sh
   (AR4JA r=4/5 k=4096, its last block punctured, ``HLMinstarapproxf32``:
   the float MinstarApprox layered kernel at bucket 32) at 2.50 and 2.75
   dB against ``results/config3_ccsds_hl.txt`` (|z| <= 3.29); and
   ``encode`` with puncturing on the card, byte for byte the CPU's file;
   then, after the counts are read, one B = 1024 step of each ``ber``
   pipeline with its decode held against the kernel's plain version on
   the step's LLRs (tolerance 0), and the 8PSK step's CUDA-event split
   (encode; the channel: puncture, interleave, modulate, noise, demap,
   deinterleave; decode; counters) with the demap's time and memory;
9. the port's last modules: (a) ``selftest`` through the command line,
   all 14 families (each rule family's kernels against the plane path,
   B = 128, 8 iterations); (b) the flagship on the torch paths, for the
   external-decoder example's offset min-sum, which has no kernel:
   ``Decoder(Code.R1_2, "Offsetminsumf32")`` (the plane-gather flooding
   path) and ``"HLOffsetminsumf32"`` (the plain layered path), their wall,
   peak memory, no kernel launched, 4 frames equal to the CPU's bit for
   bit; the plane path of ``Minsumf32`` timed in turns with its kernel,
   and at 2.5 dB held against it under the selftest's rule; (c) config 5
   of tools/run_results.sh (PEG alist, ``Minstarapproxf32``, ``ber
   --shard``, a mesh of one, B = 2048) at 1.5 and 2.0 dB against
   ``results/config5_peg_sharded.txt`` (|z| <= 3.29); (d) one
   ``HLMinsumbf16`` ``ber`` step of the flagship at 1.5 dB sharded over
   two processes that share the card (gloo), whose summed counters equal
   the unsharded step's, the kernels not built again; (e)
   ``examples/external_decoder_ber_torch.py`` on the card;
10. the probes of the card's own ceilings (``ldpc_toolbox_torch/probes``,
   the TPU probes of ``tools/prof_*.py``) at their tools' full shapes,
   each kernel held against its plain version (tolerance 0, ``fma`` too:
   see ``vpu_peak``) and timed as a chain of launches behind a busy
   stream, the host path out of the window (``probes._kernels.chain_ms``;
   the host time a launch printed beside): P1 the copy stream at the
   six slab shapes in turns with torch's ``src + 1``, P2 the four chained ops on
   132 planes beside the issue rate and the data sheet's f32 rate, P3 the
   rotated gather's four modes, P4 the copy (in turns with ``Tensor.copy_``) and
   the min-sum's contiguous and scattered writes, P5 the layered sweep's
   five variants at B = 512 and 1024 (``full`` is
   ``fused_layered_iteration``), a line a mode in the kernels JSON (but
   ``full``, #3's own line) and a ``probes`` JSON line with every rate;

each with its launch counts set to 0 just before and read just after (a
streaming path's syndrome and freeze: ``fused_syndrome_freeze``, one
launch an iteration, held against its plain version on the flagship's
tiles over five iterations of one state, and timed); both schedules'
resident, streaming (staged) and unstaged streaming loops at 2.5 dB,
where frames converge; and a two-point BER sweep of each
schedule, and of ``HLMinstarapproxi8`` and ``HLPhif32``, through
``BerTestBuilder``. Times
are medians of CUDA-event timings. Before the last line it prints a JSON
line with every kernel's launches, worst difference from its plain
version (the syndrome kernel's over both its wrappers), time, plain time
and bound (an i8 instance's from its word
steps' executed SASS instructions, tools/count_math_ops.py), after the
probes' line; the last line of standard output is
a JSON object with "ok": true. Any failure raises and exits non-zero, as
does a machine without a CUDA device.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import os
import re
import runpy
import shutil
import socket
import statistics
from collections import Counter
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ldpc_toolbox_torch.codes.ccsds import AR4JACode, AR4JAInfoSize, AR4JARate, C2Code
from ldpc_toolbox_torch.codes.dvbs2 import Code
from ldpc_toolbox_torch.codes.nr5g import BaseGraph
from ldpc_toolbox_torch import cli
from ldpc_toolbox_torch.decoder import DecodeGraph, Decoder
from ldpc_toolbox_torch.decoder.factory import make_arithmetic
from ldpc_toolbox_torch.decoder.layered import device_layers, layered_sweep
from ldpc_toolbox_torch.decoder.lifted import (
    LiftedGraph,
    lifted_graph_for,
    nr5g_maps,
)
from ldpc_toolbox_torch.decoder.lifted_flooding import (
    flooding_tiles,
    lifted_flooding_decode,
    plane_flooding_decode,
    streaming_flooding_decode,
)
from ldpc_toolbox_torch.decoder.lifted_layered import (
    lifted_layered_decode,
    plain_layered_decode,
    streaming_layered_decode,
    tile_inputs,
    tiles_to_output,
)
from ldpc_toolbox_torch.ops import _build
from ldpc_toolbox_torch.ops.fused_layered import (
    fused_layered_iteration,
    fused_layered_iteration_float,
    fused_layered_iteration_i8,
    fused_layered_iteration_reference,
)
from ldpc_toolbox_torch.ops.resident_compressed import (
    compressed_flooding_decode,
    compressed_flooding_decode_reference,
    compressed_layered_decode,
    compressed_layered_decode_reference,
)
from ldpc_toolbox_torch.ops.fused_bp2 import (
    fused_check,
    fused_check_float,
    fused_check_i8,
    fused_check_reference,
    fused_syndrome_bits,
    fused_syndrome_bits_reference,
    fused_syndrome_freeze,
    fused_syndrome_freeze_reference,
    fused_var,
    fused_var_float,
    fused_var_i8,
    fused_var_reference,
    I8_STEPS,
    i8_steps,
    i8_steps_reference,
    is_i8,
)
from ldpc_toolbox_torch.ops.resident_flooding import (
    decode_loop,
    flooding_loop,
    resident_flooding_decode,
    resident_flooding_decode_float,
    resident_flooding_decode_i8,
    resident_flooding_decode_reference,
)
from ldpc_toolbox_torch.ops.resident_layered import (
    resident_layered_decode,
    resident_layered_decode_float,
    resident_layered_decode_i8,
    resident_layered_decode_reference,
)
from ldpc_toolbox_torch.probes import _kernels as probe_kernels
from ldpc_toolbox_torch.probes import copybw, layered_variants, roll, v2, vpu_peak
from ldpc_toolbox_torch.simulation import AwgnChannel, BerTestBuilder, Modulation
from ldpc_toolbox_torch.simulation.ber import _frame_counters, step_generator
from ldpc_toolbox_torch.sparse import SparseMatrix

LAYERED = ["HLMinsumf32", "HLMinsumbf16", "HLNormminsumbf16"]
FLOODING = ["Minsumf32", "Minsumbf16", "Normminsumbf16"]
FLAGSHIP_BATCH = 1024
FLAGSHIP_EBN0 = 1.0
FLAGSHIP_ITERS = 30
R1_2_RATE = Code.R1_2.k / Code.R1_2.n
C2_RATE = 7154 / 8176  # nominal (CCSDS 131.0-B-5, Table 7-1)
#: H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM3 bytes/s
#: and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: INT32 operations/s: half the f32 rate, an SM having 64 INT32 lanes
#: against 128 FP32 lanes (NVIDIA's Hopper white paper), counted as the
#: f32 rate is (which counts a fused multiply-add as two operations)
INT32_OPS_PER_S = F32_OPS_PER_S / 2
#: operations a lane does, counted from the kernels' source: the min-sum
#: check fold and outputs per edge lane (+1 for the scale), the variable
#: rule's add and subtract per edge lane and its hard decision per
#: variable lane, the syndrome's xor per edge lane, the layered update's
#: extrinsic and delta per edge lane (with its Qv add). A compressed kernel
#: is bounded by the same count as the message kernel it shares a contract
#: with: its rebuild of messages from the compressed state is a cost of its
#: design, not work the decode needs.
CHECK_OPS, VAR_EDGE_OPS, VAR_LANE_OPS, SYN_OPS, LAYERED_EXTRA_OPS = 11, 2, 1, 1, 3
#: operations of the i8 rules besides their word steps (whose executed SASS
#: instructions are STEP_OPS["i8"]), integer, counted from csrc/i8.cuh and
#: the int8 instances. The check works on words of four frames, so its
#: operations count a word's instructions over four: per edge lane of a
#: check 12 (the input's sign bits, sign mask, magnitude, packed sign and
#: parity; the output's sign, its mask and the negation and select), per
#: slot of Aminstar 15 more (the argmin's compare, min and slot select, the
#: slot's eligibility, the fold's selects, the output's select). The
#: variable update works on a word's frames in 16-bit halves: per edge
#: lane 16 a word (the spread into halves and their adds; the output's
#: subtracts, clamps, packing and sign flip), per variable lane 10 (the
#: Jones clamps, the hard decisions). Per frame: per edge lane of the
#: layered update the extrinsic and its clip, the delta and the Qv add
I8_EDGE_OPS, I8_SLOT_OPS = 12 / 4, 15 / 4
I8_VAR_EDGE_OPS, I8_VAR_LANE_OPS, I8_LAYERED_EXTRA_OPS = 16 / 4, 10 / 4, 5
#: FP64 operations/s outside the tensor cores (NVIDIA's data sheet, H100
#: SXM): the rate of the float rules' f64 instances
F64_OPS_PER_S = 34e12
#: MUFU (special-function) operations/s: an SM has 16 SFU lanes against 128
#: FP32 lanes (NVIDIA's Hopper white paper), counted as the f32 rate is
SFU_OPS_PER_S = F32_OPS_PER_S / 8
#: the rate of each class of instruction of tools/count_math_ops.py
PIPE_OPS_PER_S = {"f32": F32_OPS_PER_S, "f64": F64_OPS_PER_S, "sfu": SFU_OPS_PER_S,
                  "int": INT32_OPS_PER_S}
#: instructions a call of each step of the float rules executes, by class:
#: the fewest any argument in the messages' range takes (the probe kernels'
#: PTX, tools/count_math_ops.py on the card, PERF.md section 6); and of the
#: i8 rules' word steps, a word of four frames, from the SASS (the same
#: tool: "f32" counts IMAD, which issues to the FMA pipe)
STEP_OPS = {
    "i8": {
        "tab4": {"int": 14, "f32": 0},
        "minstar_approx4": {"int": 22, "f32": 1},
        "minstar_full4": {"int": 38, "f32": 2},
        "phl4": {"int": 3, "f32": 0},
    },
    "float": {
        "phi": {"f32": 43, "sfu": 1, "int": 15},
        "minstar_approx": {"f32": 26, "sfu": 1, "int": 11},
        "minstar_full": {"f32": 48, "sfu": 2, "int": 23},
        "tanh_half": {"f32": 18, "sfu": 2, "int": 4},
        "atanh2": {"f32": 37, "int": 15},
    },
    "double": {
        "phi": {"f32": 3, "f64": 50, "int": 9},
        "minstar_approx": {"f32": 3, "f64": 35, "int": 7},
        "minstar_full": {"f32": 6, "f64": 66, "int": 13},
        "tanh_half": {"f64": 19, "int": 2},
        "atanh2": {"f32": 4, "f64": 35, "int": 6},
    },
}
#: operations of the float rules on one frame besides the steps, counted
#: from csrc/float_rules.cuh, in the storage type's class (fp) or the
#: integer one: per slot of Phi, MinstarApprox and Aminstar its magnitude
#: (an abs, int) and sign (the compare, fp; the mask, the parity and the
#: output's sign, int); per slot of Phi the sum's add and the subtract
#: before the second phi; of Tanh its three products (the suffix, pre *
#: suf, pre * tn); of Aminstar the argmin's compare (fp), its two selects
#: and the output's (int)
SLOT_FP, SLOT_INT = 1, 4
PHI_SLOT_FP, TANH_SLOT_FP, AMIN_SLOT_FP, AMIN_SLOT_INT = 2, 3, 1, 3
#: per edge lane and frame of each part of a float iteration, by schedule
#: (layered True): the check's missing-lane select of its input (int);
#: the update, layered the extrinsic, the delta and the Qv add (fp) and
#: the missing-lane select of Rnew (int), flooding the variable rule's add
#: and subtract (fp) and the missing-lane select of the output (int); the
#: syndrome's xor (int); and per variable lane the flooding update's hard
#: decision (fp)
FLOAT_EDGE_PARTS = {
    True: {"check": {"int": 1}, "update": {"fp": 3, "int": 1}, "syndrome": {"int": 1}},
    False: {"check": {"int": 1}, "update": {"fp": 2, "int": 1}, "syndrome": {"int": 1}},
}
FLOAT_LANE_PARTS = {True: {}, False: {"update": {"fp": 1}}}
#: the parts of an iteration: the check rule, the update (layered: of Qv
#: and Rcv; flooding: the variable phase), the syndrome; a streaming phase
#: or sweep does some of them
PARTS = ("check", "update", "syndrome")
PHASES = ("fused_check", "fused_var", "fused_syndrome_freeze")
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "resident_layered_decode": (
        "ldpc_toolbox_torch/csrc/resident_layered.cu",
        "ldpc_toolbox_tpu/ops/resident_layered.py:193"),
    "compressed_layered_decode": (
        "ldpc_toolbox_torch/csrc/compressed.cu",
        "ldpc_toolbox_tpu/ops/resident_compressed.py:524"),
    "fused_layered_iteration": (
        "ldpc_toolbox_torch/csrc/fused_layered.cu",
        "ldpc_toolbox_tpu/ops/fused_layered.py:39"),
    "resident_flooding_decode": (
        "ldpc_toolbox_torch/csrc/flooding.cu",
        "ldpc_toolbox_tpu/ops/resident_flooding_dual.py:133 and "
        "ldpc_toolbox_tpu/ops/resident_flooding.py:144"),
    "compressed_flooding_decode": (
        "ldpc_toolbox_torch/csrc/compressed.cu",
        "ldpc_toolbox_tpu/ops/resident_compressed.py:149"),
    "fused_check": (
        "ldpc_toolbox_torch/csrc/flooding.cu",
        "ldpc_toolbox_tpu/ops/fused_bp2.py:774"),
    "fused_var": (
        "ldpc_toolbox_torch/csrc/flooding.cu",
        "ldpc_toolbox_tpu/ops/fused_bp2.py:910"),
    # the syndrome kernel as the streaming loops launch it, with their
    # freeze (fused_syndrome_bits launches it for the flags alone)
    "fused_syndrome_freeze": (
        "ldpc_toolbox_torch/csrc/flooding.cu",
        "ldpc_toolbox_tpu/ops/fused_bp2.py:1098"),
    # the int8 instances of #1 and #4/#5, for the i8 rules those TPU
    # kernels inline (ldpc_toolbox_tpu/ops/fused_bp2.py:546-697)
    "resident_layered_decode_i8": (
        "ldpc_toolbox_torch/csrc/resident_layered_i8.cu",
        "ldpc_toolbox_tpu/ops/resident_layered.py:193"),
    "resident_flooding_decode_i8": (
        "ldpc_toolbox_torch/csrc/flooding_i8.cu",
        "ldpc_toolbox_tpu/ops/resident_flooding_dual.py:133 and "
        "ldpc_toolbox_tpu/ops/resident_flooding.py:144"),
    # the float-rule instances of #1 and #4/#5 (the kernels of
    # csrc/message_kernels.cuh on the rules of csrc/float_rules.cuh, f32 in
    # *_f32.cu, f64 in *_f64.cu), for the float rules those TPU kernels
    # inline (ldpc_toolbox_tpu/ops/fused_bp2.py:331-527)
    "resident_layered_decode_float": (
        "ldpc_toolbox_torch/csrc/float_rules.cuh",
        "ldpc_toolbox_tpu/ops/resident_layered.py:193"),
    "resident_flooding_decode_float": (
        "ldpc_toolbox_torch/csrc/float_rules.cuh",
        "ldpc_toolbox_tpu/ops/resident_flooding_dual.py:133 and "
        "ldpc_toolbox_tpu/ops/resident_flooding.py:144"),
    # the i8 and float-rule instances of the streaming kernels #3, #7 and
    # #8 (the templates of csrc/streaming.cuh on I8Rule and FloatRule; the
    # i8 sweep and check phase kernels of their own, csrc/i8_streaming.cuh)
    "fused_layered_iteration_i8": (
        "ldpc_toolbox_torch/csrc/i8_streaming.cuh",
        "ldpc_toolbox_tpu/ops/fused_layered.py:39"),
    "fused_layered_iteration_float": (
        "ldpc_toolbox_torch/csrc/float_rules.cuh",
        "ldpc_toolbox_tpu/ops/fused_layered.py:39"),
    "fused_check_i8": (
        "ldpc_toolbox_torch/csrc/i8_streaming.cuh",
        "ldpc_toolbox_tpu/ops/fused_bp2.py:774"),
    "fused_check_float": (
        "ldpc_toolbox_torch/csrc/float_rules.cuh",
        "ldpc_toolbox_tpu/ops/fused_bp2.py:774"),
    "fused_var_i8": (
        "ldpc_toolbox_torch/csrc/flooding_i8.cu",
        "ldpc_toolbox_tpu/ops/fused_bp2.py:910"),
    "fused_var_float": (
        "ldpc_toolbox_torch/csrc/float_rules.cuh",
        "ldpc_toolbox_tpu/ops/fused_bp2.py:910"),
    # the f32 instances of #4/#5, #7 and #8 apart (their thread map is their
    # own: FloatRule<float>'s FloodUnits and VarUnits), from Phif32's paths
    "resident_flooding_decode_float:f32": (
        "ldpc_toolbox_torch/csrc/flooding_f32.cu",
        "ldpc_toolbox_tpu/ops/resident_flooding_dual.py:133 and "
        "ldpc_toolbox_tpu/ops/resident_flooding.py:144"),
    "fused_check_float:f32": (
        "ldpc_toolbox_torch/csrc/flooding_f32.cu",
        "ldpc_toolbox_tpu/ops/fused_bp2.py:774"),
    "fused_var_float:f32": (
        "ldpc_toolbox_torch/csrc/flooding_f32.cu",
        "ldpc_toolbox_tpu/ops/fused_bp2.py:910"),
}
WRAPPERS = (
    resident_layered_decode, compressed_layered_decode, fused_layered_iteration,
    resident_flooding_decode, compressed_flooding_decode, fused_check,
    fused_var, fused_syndrome_bits, fused_syndrome_freeze, resident_layered_decode_i8,
    resident_flooding_decode_i8, resident_layered_decode_float,
    resident_flooding_decode_float, fused_layered_iteration_i8,
    fused_layered_iteration_float, fused_check_i8, fused_check_float, fused_var_i8,
    fused_var_float,
)
#: the i8 and float instances' wrappers of the streaming kernels: (sweep,
#: check, variable)
STREAMING = {
    "i8": (fused_layered_iteration_i8, fused_check_i8, fused_var_i8),
    "float": (fused_layered_iteration_float, fused_check_float, fused_var_float),
}
#: the i8 names the kernel checks run, two a schedule
I8_LAYERED = ["HLMinstarapproxi8", "HLAminstari8PartialHardLimit"]
I8_FLOODING = ["Minstarapproxi8JonesDeg1Clip", "Aminstari8PartialHardLimitDeg1Clip"]
#: the 16 float names: four rules, two precisions, two schedules
FLOAT_NAMES = [s + r + p for s in ("", "HL") for r in ("Phi", "Tanh", "Minstarapprox", "Aminstar")
               for p in ("f32", "f64")]
DECODE_KEYS = ("codeword", "iterations", "success")
#: name -> (output, Decoder.decode_batch ms) of the lifted flagship decodes
#: that the generic phase compares with (filled by the flagship phases)
LIFTED = {}


def sigma_at(rate, ebn0_db):
    """The BPSK noise sigma of an Eb/N0 at a code rate."""
    return float(np.sqrt(0.5 / (rate * 10 ** (0.1 * ebn0_db))))


def channel_llrs(n, batch, sigma, seed):
    """All-zero codeword over BPSK + AWGN, as bench.py makes them."""
    rng = np.random.default_rng(seed)
    x = -1.0 + sigma * rng.standard_normal((batch, n), dtype=np.float32)
    return torch.from_numpy((-2.0 / sigma**2) * x).cuda()


def strong_llrs(n, batch, seed):
    """Large-magnitude LLRs (6 to 20) with 1 to 6 % of the signs flipped:
    the i8 checks then see magnitudes near 127, where the partial hard
    limit, the Jones clip and the Deg1Clip act."""
    rng = np.random.default_rng(seed)
    mag = rng.uniform(6.0, 20.0, (batch, n))
    flip = rng.random((batch, n)) < rng.uniform(0.01, 0.06, (batch, 1))
    return torch.from_numpy(np.where(flip, -mag, mag).astype(np.float32)).cuda()


def event_ms(fn):
    """One CUDA-event timing of fn() in milliseconds."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def timed_once(fn):
    """(fn()'s result, one CUDA-event timing of it in milliseconds): a plain
    version's run that both holds a kernel and gives its time."""
    out = []
    ms = event_ms(lambda: out.append(fn()))
    return out[0], ms


def cuda_ms(fn, reps):
    """Median of ``reps`` timings of fn() in milliseconds, CUDA events,
    after one warm-up call."""
    fn()
    return statistics.median(event_ms(fn) for _ in range(reps))


def pair_ms(fa, fb, reps):
    """Medians of ``reps`` timings each of fa() and fb(), taken in turns
    (a b, b a, a b, ...) after a warm-up call of each, so that the two are
    compared on the same card at the same time."""
    fa()
    fb()
    ta, tb = [], []
    for r in range(reps):
        for fn, ts in ((fa, ta), (fb, tb)) if r % 2 == 0 else ((fb, tb), (fa, ta)):
            ts.append(event_ms(fn))
    return statistics.median(ta), statistics.median(tb)


def max_abs_diff(xs, ys):
    """Largest |x - y| over pairs of tensors of equal shape (floats
    compared in float64, so big and the bf16 values are exact)."""
    worst = 0.0
    for x, y in zip(xs, ys):
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape)
        worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the least time of the work on the
    card, the larger of the bytes over the memory rate and the operations
    over their type's rate (f32 unless given)."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def sass(so):
    """{kernel: its SASS instructions} of the library ``so`` (addresses
    and encodings dropped), demangled names."""
    dump = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
                           "-sass", str(so)], capture_output=True, text=True, check=True).stdout
    kernels, name = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)):
            kernels[name].append(m.group(1))
    names = subprocess.run(["c++filt"], input="\n".join(kernels), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    short = (re.sub(r"\(anonymous namespace\)::|ldpc::", "", n).split("(")[0] for n in names)
    return {n: kernels[k] for n, k in zip(short, kernels)}


def i8_folds(kind, d):
    """(the word step, its calls) of one check of degree d under an i8 rule:
    MinstarApprox's folds (the prefixes and each slot's rest, with prefix
    reuse), or Aminstar's full min* fold over every slot but the minimum's
    and its shared output (d + 1 calls, the first minimum's own too)."""
    if kind == 0:
        return "minstar_approx4", 2 * (d - 2) + (d - 2) * (d - 1) // 2 if d >= 2 else 0
    return "minstar_full4", d + 1


def i8_check_ops(kind, d):
    """Operations of one check of degree d under an i8 rule on one frame,
    by class: its folds at their executed instructions (``STEP_OPS``, a
    word's over four), Aminstar's slot work, and the per-edge work."""
    step, calls = i8_folds(kind, d)
    ops = Counter({cls: calls * n / 4 for cls, n in STEP_OPS["i8"][step].items()})
    ops["int"] += d * (I8_EDGE_OPS + (I8_SLOT_OPS if kind == 1 else 0))
    return ops


def i8_iteration_ops(layout, rule, layered, parts=PARTS):
    """Operations of the ``parts`` of one iteration of one frame under an
    i8 rule (``PARTS``; all of them by default), by class: every check
    group's rule work ("check"), the layered update's or the variable
    phase's ("update") and the syndrome's, per edge lane and variable lane;
    times Z."""
    ops = Counter()
    if "check" in parts:
        for m in layout.chk_meta:
            for cls, n in i8_check_ops(rule.kind, m.d).items():
                ops[cls] += (m.g1 - m.g0) * n
    if "update" in parts:
        ops["int"] += (layout.E * I8_LAYERED_EXTRA_OPS if layered
                       else layout.E * I8_VAR_EDGE_OPS + layout.VG * I8_VAR_LANE_OPS)
    if "syndrome" in parts:
        ops["int"] += layout.E * SYN_OPS
    return Counter({cls: n * layout.Z for cls, n in ops.items()})


def i8_word_folds(layout, rule):
    """Word steps (folds) of one iteration of one tile under an i8 rule:
    each check lane's folds, a word serving the tile's four frames."""
    return layout.Z * sum((m.g1 - m.g0) * i8_folds(rule.kind, m.d)[1] for m in layout.chk_meta)


def float_check_ops(rule, d, fp):
    """Operations of one check of degree d under a float rule on one frame,
    by class (``fp`` the storage type's): the executed instructions of its
    steps (``STEP_OPS``): Phi's two phis a slot, Tanh's tanh_half and
    atanh2 a slot, MinstarApprox's folds (the prefixes and each slot's
    rest, with prefix reuse), Aminstar's d - 1 full min* (the fold over the
    d - 1 slots but the first minimum's, then that with the minimum); and
    the rest (magnitudes, signs, sums, products, the argmin)."""
    steps = STEP_OPS["double" if fp == "f64" else "float"]
    ops = Counter()

    def add(step, calls):
        for cls, n in steps[step].items():
            ops[cls] += calls * n

    if rule.kind == 0:
        add("phi", 2 * d)
        ops[fp] += d * (SLOT_FP + PHI_SLOT_FP)
        ops["int"] += d * SLOT_INT
    elif rule.kind == 1:
        add("tanh_half", d)
        add("atanh2", d)
        ops[fp] += d * TANH_SLOT_FP
    elif rule.kind == 2:
        add("minstar_approx", 2 * (d - 2) + (d - 2) * (d - 1) // 2 if d >= 2 else 0)
        ops[fp] += d * SLOT_FP
        ops["int"] += d * SLOT_INT
    else:
        add("minstar_full", max(d - 1, 1))
        ops[fp] += d * (SLOT_FP + AMIN_SLOT_FP)
        ops["int"] += d * (SLOT_INT + AMIN_SLOT_INT)
    return ops


def float_iteration_ops(layout, rule, layered, parts=PARTS):
    """Operations of the ``parts`` of one iteration of one frame under a
    float rule (``PARTS``; all of them by default), by class: every check
    group's rule work ("check"), the layered update's or the variable
    phase's ("update") and the syndrome's, per edge lane and variable lane;
    times Z."""
    fp = "f64" if rule.storage_dtype == torch.float64 else "f32"
    ops = Counter()
    if "check" in parts:
        for m in layout.chk_meta:
            for cls, n in float_check_ops(rule, m.d, fp).items():
                ops[cls] += (m.g1 - m.g0) * n
    for table, count in ((FLOAT_EDGE_PARTS, layout.E), (FLOAT_LANE_PARTS, layout.VG)):
        for part, per in table[layered].items():
            if part in parts:
                for cls, n in per.items():
                    ops[fp if cls == "fp" else cls] += count * n
    return Counter({cls: n * layout.Z for cls, n in ops.items()})


def bound_pipes(nbytes, ops):
    """``bound`` of work on several pipes, ``ops`` {class: operations}
    (``PIPE_OPS_PER_S``): the operations' least time is the most that one
    pipe needs at its rate, or that all of them need at the issue rate (a
    sub-partition issues one instruction a clock, the rate of the f32
    lanes), whichever is more. Returns (ms, "bytes" or "operations", the
    binding pipe or "issue")."""
    by_pipe = {cls: n / PIPE_OPS_PER_S[cls] for cls, n in ops.items()}
    by_pipe["issue"] = sum(ops.values()) / F32_OPS_PER_S
    pipe = max(by_pipe, key=by_pipe.get)
    by_ops, by_bytes = by_pipe[pipe], nbytes / HBM_BYTES_PER_S
    return (1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            pipe)


def tile_iterations(iters, bt):
    """Iterations each tile ran: a tile stops once its frames have all
    converged, so it runs as many as its slowest frame."""
    return iters.reshape(-1, bt).max(dim=1).values


def hold(worst, kernel, label, out, ref):
    """Fail unless a kernel's outputs equal its plain version's; keep the
    kernel's worst difference in ``worst``; returns the difference."""
    err = max_abs_diff(out, ref)
    worst[kernel] = max(worst[kernel], err)
    assert err == 0, f"{kernel} differs from its plain version: {label}"
    return err


def same_decode(a, b, what):
    """Fail unless two decoder outputs agree in codewords, iterations and
    success."""
    for key in DECODE_KEYS:
        assert torch.equal(a[key], b[key]), f"{what}: {key} differs"


def freeze_state(bits):
    """A streaming loop's state for the tiles of ``bits`` before its first
    test: (frozen, conv, iters, counter), no frame converged."""
    frames, dev = bits.shape[0] * bits.shape[-1], bits.device
    return (torch.empty_like(bits), torch.zeros(frames, dtype=torch.bool, device=dev),
            torch.zeros(frames, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def freeze_checks(worst, tag, layout, steps):
    """``fused_syndrome_freeze`` against its plain version on one state, in
    place, over the bits of iterations 0, 1, ... (``steps``), each step
    bit for bit; returns the frames that passed."""
    mine = freeze_state(steps[0])
    mine[0].zero_()
    plain = tuple(x.clone() for x in mine)
    for it, b in enumerate(steps):
        fused_syndrome_freeze(b, *mine[:3], it, mine[3], layout)
        fused_syndrome_freeze_reference(b, *plain[:3], it, plain[3], layout)
        hold(worst, "fused_syndrome_freeze", f"{tag}, freeze {it}", mine, plain)
    return int(mine[1].sum())


def syndrome_bound(bits, layout, flags):
    """``bound`` of a ``fused_syndrome_freeze`` launch on ``bits`` whose
    plain flags are ``flags``, no frame passing for the first time: what
    this data needs read. A tile with a passing frame has every check read
    (its bits once, an xor an edge lane); a tile whose frames all fail at
    least one check lane's words (one word holds a lane's four frames; the
    least check degree); conv is read and the count written (iters is not
    read, conv not written: no frame passes for the first time)."""
    nbt, VG, Z, Bt = bits.shape
    passing = int((flags == 0).any(dim=1).sum())
    least = min(m.d for m in layout.chk_meta if m.d)
    nbytes = passing * VG * Z * Bt + (nbt - passing) * least * 4 + nbt * Bt + 4
    return bound(nbytes, (passing * layout.E * Z + (nbt - passing) * least) * Bt * SYN_OPS)


def freeze_ms(bits, layout, reps):
    """(kernel, plain version) ms of one ``fused_syndrome_freeze`` of
    ``bits`` on a state where no frame has converged (in place: once a
    frame has passed, it does not pass for the first time again)."""
    mine, plain = freeze_state(bits), freeze_state(bits)
    return (cuda_ms(lambda: fused_syndrome_freeze(bits, *mine[:3], 1, mine[3], layout), reps),
            cuda_ms(lambda: fused_syndrome_freeze_reference(bits, *plain[:3], 1, plain[3],
                                                            layout), 3))


def reset_counts():
    for fn in WRAPPERS:
        fn.launches = 0


def counts():
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def entry(launches, ms, plain_ms, bound_and_by):
    """A kernel's measured numbers for the ``kernels`` line."""
    bound_ms, bound_by = bound_and_by
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(libs)} sources, "
          "one nvcc each, in parallel")
    for name, (lib, seconds) in libs.items():
        print(f"  {name}: ready after {seconds:.1f} s, {lib}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())


def qc_degree40():
    """A quasi-cyclic code of 3 x 40 circulants of Z = 16, each a seeded
    shift: every check of degree 40, the 64 bucket, which no standards code
    reaches (tests/test_torch_cuda.py builds the same code)."""
    rng = np.random.default_rng(64)
    z, rows, cols = 16, 3, 40
    h = SparseMatrix(rows * z, cols * z)
    for r in range(rows):
        for c in range(cols):
            s = int(rng.integers(z))
            for i in range(z):
                h.insert(r * z + i, c * z + (i + s) % z)
    blocks = lambda j: (j // z, j % z)  # noqa: E731
    return LiftedGraph.from_sparse(h, blocks, blocks, z, cols, rows)


def test_graphs():
    bg2 = LiftedGraph.from_sparse(BaseGraph.BG2.h(16), *nr5g_maps(BaseGraph.BG2, 16))
    bg1 = LiftedGraph.from_sparse(BaseGraph.BG1.h(16), *nr5g_maps(BaseGraph.BG1, 16))
    return {
        "5G BG2 z=16": bg2,
        "DVB-S2 R1_4short": lifted_graph_for(Code.R1_4short),
        "DVB-S2 R1_2": lifted_graph_for(Code.R1_2),
        "CCSDS C2": lifted_graph_for(C2Code()),
        "AR4JA K1024 R1_2": lifted_graph_for(AR4JACode(AR4JARate.R1_2, AR4JAInfoSize.K1024)),
        "AR4JA K1024 R4_5": lifted_graph_for(AR4JACode(AR4JARate.R4_5, AR4JAInfoSize.K1024)),
        "5G BG1 z=16": bg1,
        "QC 3x40 z=16": qc_degree40(),
    }


def zero_rcv(qv0, layout, rule):
    nbt, _, Z, Bt = qv0.shape
    return torch.zeros((nbt, layout.E, Z, Bt), dtype=rule.storage_dtype, device=qv0.device)


def layered_checks(graphs, worst):
    """The three layered kernels against their plain versions (the
    streaming sweep for one and for two sweeps on the same planes), and the
    whole streaming decode against the resident one; worst differences
    into ``worst``."""
    cases = [
        ("5G BG2 z=16", 256, 1.3, 10),
        ("DVB-S2 R1_4short", 128, 1.05, 8),
        ("DVB-S2 R1_2", 128, sigma_at(R1_2_RATE, 1.5), 30),
        ("CCSDS C2", 128, sigma_at(C2_RATE, 4.0), 10),
    ]
    for label, batch, sigma, iters in cases:
        lg = graphs[label]
        llrs = channel_llrs(lg.n, batch, sigma, seed=5)
        for name in LAYERED:
            tag = f"{label} B={batch} {name}"
            args = tile_inputs(lg, make_arithmetic(name)[1], llrs)
            out = resident_layered_decode(*args, iters)
            hold(worst, "resident_layered_decode", tag, out,
                 resident_layered_decode_reference(*args, iters))
            hold(worst, "compressed_layered_decode", tag,
                 compressed_layered_decode(*args, iters),
                 compressed_layered_decode_reference(*args, iters))
            qv0, _, layout, rule = args
            rcv0 = zero_rcv(qv0, layout, rule)
            kernel, plain = (qv0.clone(), rcv0.clone()), (qv0.clone(), rcv0.clone())
            for sweep in (1, 2):
                k = fused_layered_iteration(*kernel, layout, rule)
                p = fused_layered_iteration_reference(*plain, layout, rule)
                hold(worst, "fused_layered_iteration", f"{tag}, sweep {sweep}", k, p)
                kernel, plain = k[:2], p[:2]
            stream = streaming_layered_decode(*args, iters)
            assert max_abs_diff(out, stream) == 0, f"streaming layered differs: {tag}"
            torch.cuda.synchronize()
            print(f"layered kernels vs plain: {tag}: resident, compressed and the "
                  f"streaming sweep (one and two sweeps) equal (tolerance 0), the "
                  f"streaming decode equals resident, {int(out[2].sum())}/"
                  f"{out[2].numel()} converged")
    bg2 = graphs["5G BG2 z=16"]
    llrs = channel_llrs(bg2.n, 130, 1.3, seed=11)
    for name in ("HLMinsumbf16", "HLMinsumf32"):
        _, arith = make_arithmetic(name)
        out = lifted_layered_decode(bg2, arith, llrs, 10)
        same_decode(out, plain_layered_decode(bg2, arith, llrs, 10), f"partial tile {name}")
        same_decode(out, lifted_layered_decode(bg2, arith, llrs, 10, resident=False),
                    f"partial tile streaming {name}")
        print(f"layered kernels vs plain: 5G BG2 z=16 B=130 (partial tile) {name}: "
              f"{int(out['success'].sum())}/130 converged; resident, streaming and "
              "the plain version equal")


def flooding_checks(graphs, worst):
    """Each flooding kernel against its plain version on the same inputs,
    and the streaming path against the resident one; worst differences
    into ``worst``."""
    cases = [
        ("5G BG2 z=16", 256, 1.3, 10),
        ("DVB-S2 R1_4short", 128, 0.85, 8),
        ("DVB-S2 R1_2", 128, sigma_at(R1_2_RATE, 1.5), 30),
        ("CCSDS C2", 128, sigma_at(C2_RATE, 4.0), 10),
    ]
    for label, batch, sigma, iters in cases:
        lg = graphs[label]
        llrs = channel_llrs(lg.n, batch, sigma, seed=5)
        for name in FLOODING:
            tag = f"{label} B={batch} {name}"
            q, bits0, layout, rule = flooding_tiles(lg, make_arithmetic(name)[1], llrs)
            v2c0 = fused_var(None, q, layout, rule)
            hold(worst, "fused_var", tag, v2c0, fused_var_reference(None, q, layout, rule))
            c2v = fused_check(v2c0[0], layout, rule)
            hold(worst, "fused_check", tag, [c2v], [fused_check_reference(v2c0[0], layout, rule)])
            v2c = fused_var(c2v, q, layout, rule)
            hold(worst, "fused_var", tag, v2c, fused_var_reference(c2v, q, layout, rule))
            for b in (bits0, v2c[1]):
                hold(worst, "fused_syndrome_bits", f"{tag}, flags",
                     [fused_syndrome_bits(b, layout)], [fused_syndrome_bits_reference(b, layout)])
            args = (q, bits0, layout, rule, iters)
            out = resident_flooding_decode(*args)
            hold(worst, "resident_flooding_decode", tag, out,
                 resident_flooding_decode_reference(*args))
            hold(worst, "compressed_flooding_decode", tag, compressed_flooding_decode(*args),
                 compressed_flooding_decode_reference(*args))
            stream = streaming_flooding_decode(*args)
            assert max_abs_diff(out, stream) == 0, f"streaming differs: {tag}"
            torch.cuda.synchronize()
            print(f"flooding kernels vs plain: {tag}: each phase, the resident and "
                  f"the compressed decode equal (tolerance 0), streaming equals "
                  f"resident, {int(out[2].sum())}/{out[2].numel()} converged")
    bg2 = graphs["5G BG2 z=16"]
    llrs = channel_llrs(bg2.n, 130, 1.3, seed=11)
    for name in ("Minsumbf16", "Minsumf32"):
        _, arith = make_arithmetic(name)
        out = lifted_flooding_decode(bg2, arith, llrs, 10)
        stream = lifted_flooding_decode(bg2, arith, llrs, 10, resident=False)
        plain = lifted_flooding_decode(bg2, arith, llrs.cpu(), 10)
        same_decode(out, stream, f"partial tile streaming {name}")
        same_decode({k: v.cpu() for k, v in out.items()}, plain, f"partial tile plain {name}")
        print(f"flooding kernels vs plain: 5G BG2 z=16 B=130 (partial tile) {name}: "
              f"{int(out['success'].sum())}/130 converged; resident, streaming and "
              "the plain versions on the CPU equal")


def compressed_checks(graphs, worst):
    """The compressed kernels' normalized f32 names (the names they carry
    besides the checks above) on every test code, against their plain
    versions."""
    cases = [
        ("5G BG2 z=16", 256, 1.3, 10),
        ("DVB-S2 R1_4short", 128, 1.05, 8),
        ("DVB-S2 R1_2", 128, sigma_at(R1_2_RATE, 1.5), 30),
        ("CCSDS C2", 128, sigma_at(C2_RATE, 4.0), 10),
    ]
    for label, batch, sigma, iters in cases:
        lg = graphs[label]
        llrs = channel_llrs(lg.n, batch, sigma, seed=5)
        layered = tile_inputs(lg, make_arithmetic("HLNormminsumf32")[1], llrs)
        flooding = flooding_tiles(lg, make_arithmetic("Normminsumf32")[1], llrs)
        tag = f"{label} B={batch}"
        hold(worst, "compressed_layered_decode", f"{tag} HLNormminsumf32",
             compressed_layered_decode(*layered, iters),
             compressed_layered_decode_reference(*layered, iters))
        hold(worst, "compressed_flooding_decode", f"{tag} Normminsumf32",
             compressed_flooding_decode(*flooding, iters),
             compressed_flooding_decode_reference(*flooding, iters))
        torch.cuda.synchronize()
        print(f"compressed kernels vs plain: {tag}: HLNormminsumf32 (layered) and "
              "Normminsumf32 (flooding) equal (tolerance 0)")


def flagship_layered(card, llrs):
    """Main path 1: the layered decode (HLMinsumbf16, resident); its
    kernel's numbers."""
    code = Code.R1_2
    dec = Decoder(code, "HLMinsumbf16", device="cuda")
    reset_counts()
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
    torch.cuda.synchronize()
    launches = resident_layered_decode.launches
    assert launches > 0, "the layered main path did not launch its kernel"
    ref, plain_decode_ms = timed_once(
        lambda: plain_layered_decode(dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS))
    err = max_abs_diff([out[k] for k in DECODE_KEYS], [ref[k] for k in DECODE_KEYS])
    assert err == 0, "flagship layered decode differs from the plain version"
    assert out["codeword"].shape == (FLAGSHIP_BATCH, code.n)
    iters = out["iterations"]
    print(f"flagship layered decode: {launches} kernel launch(es), output equal "
          f"to the plain version (tolerance 0), "
          f"{int(out['success'].sum())}/{FLAGSHIP_BATCH} converged, "
          f"average iterations {float(iters.float().mean()):.2f}")

    executed = int(iters.max())
    decode_ms = cuda_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 5)
    args = tile_inputs(dec.lifted, dec.arithmetic, llrs)
    kernel_ms = cuda_ms(lambda: resident_layered_decode(*args, FLAGSHIP_ITERS), 5)
    plain_ms = event_ms(lambda: resident_layered_decode_reference(*args, FLAGSHIP_ITERS))
    qv0, bits0, layout, _ = args
    nbt, VG, Z, Bt = qv0.shape
    lanes = VG * Z * Bt * nbt
    edge_tile = layout.E * Z * Bt
    tile_its = int(tile_iterations(iters, Bt).sum())
    ops = tile_its * edge_tile * (CHECK_OPS + LAYERED_EXTRA_OPS + SYN_OPS + 1)
    bound_ms, bound_by = bound(lanes * (4 + 1 + 1) + nbt * Bt * 8, ops)
    # per edge lane: Qv f32 read for x, read and written for the update and
    # read for the syndrome, Rcv bf16 read and written
    state_ms = 1e3 * tile_its * edge_tile * 20 / HBM_BYTES_PER_S
    mbps = 1e-6 * code.k * FLAGSHIP_BATCH / (decode_ms * 1e-3)
    print(f"[{card}] flagship layered Decoder.decode_batch: {decode_ms:.3f} ms, "
          f"{mbps:.1f} Mbit/s decoded info, {decode_ms / executed:.3f} ms/iter "
          f"({executed} iterations executed), median of 5")
    print(f"[{card}] flagship layered plain decode: {plain_decode_ms:.3f} ms, "
          f"{plain_decode_ms / executed:.3f} ms/iter, one run")
    print(f"[{card}] resident_layered_decode kernel: {kernel_ms:.3f} ms "
          f"({kernel_ms / executed:.3f} ms/iter); plain version {plain_ms:.3f} ms (one run); "
          f"bound {bound_ms:.4f} ms by {bound_by} (inputs and outputs once); "
          f"state-traffic floor {state_ms:.3f} ms ({tile_its} tile-iterations)")
    return dec, {"resident_layered_decode": entry(launches, kernel_ms, plain_ms,
                                                  (bound_ms, bound_by))}


def flooding_bounds(tiles, iters):
    """(bound ms, what sets it, state-traffic floor ms, tile-iterations) of
    the min-sum resident flooding decode of ``tiles`` whose frames ran
    ``iters``: the bound counts the inputs and outputs once and each
    tile-iteration's operations; the floor, a tile-iteration's v2c and c2v
    read and written, q read, the bits written and read once per edge by the
    syndrome."""
    q, _, layout, rule = tiles
    nbt, VG, Z, Bt = q.shape
    s, lanes = q.element_size(), VG * Z * Bt * nbt
    tile_its = int(tile_iterations(iters, Bt).sum())
    edge_tile, lane_tile = layout.E * Z * Bt, VG * Z * Bt
    ops = tile_its * (edge_tile * (CHECK_OPS + int(rule.scale != 1.0) + VAR_EDGE_OPS + SYN_OPS)
                      + lane_tile * VAR_LANE_OPS)
    ms, by = bound(lanes * (s + 1 + 1) + nbt * Bt * 8, ops)
    state_ms = 1e3 * tile_its * (4 * edge_tile * s + lane_tile * (s + 1) + edge_tile) \
        / HBM_BYTES_PER_S
    return ms, by, state_ms, tile_its


def flagship_flooding(card, llrs, worst):
    """Main path 2: the flooding decode, resident (through the Decoder) and
    streaming; each phase kernel against its plain version on the
    flagship's planes (worst differences into ``worst``); resident against
    streaming at 2.5 dB, where frames converge and freeze; the numbers of
    its four kernels."""
    code = Code.R1_2
    dec = Decoder(code, "Minsumbf16", device="cuda")
    reset_counts()
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
    torch.cuda.synchronize()
    resident_launches = resident_flooding_decode.launches
    assert resident_launches > 0, "the flooding main path did not launch its kernel"
    tiles = flooding_tiles(dec.lifted, dec.arithmetic, llrs)
    ref = tiles_to_output(
        dec.lifted, *resident_flooding_decode_reference(*tiles, FLAGSHIP_ITERS),
        FLAGSHIP_BATCH,
    )
    err = max_abs_diff([out[k] for k in DECODE_KEYS], [ref[k] for k in DECODE_KEYS])
    assert err == 0, "flagship flooding decode differs from the plain version"
    assert out["codeword"].shape == (FLAGSHIP_BATCH, code.n)

    reset_counts()
    stream = lifted_flooding_decode(
        dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS, resident=False
    )
    torch.cuda.synchronize()
    phase_launches = {name: n for name, n in counts().items() if name in PHASES}
    assert all(phase_launches.values()), f"streaming path: {phase_launches}"
    assert resident_flooding_decode.launches == 0
    same_decode(out, stream, "streaming flagship")
    iters = out["iterations"]
    executed = int(iters.max())
    print(f"flagship flooding decode: {resident_launches} resident kernel "
          f"launch(es), output equal to the plain version (tolerance 0); the "
          f"streaming path ({phase_launches}) gives the same output; "
          f"{int(out['success'].sum())}/{FLAGSHIP_BATCH} converged, average "
          f"iterations {float(iters.float().mean()):.2f}, {executed} executed")

    q, bits0, layout, rule = tiles
    nbt, VG, Z, Bt = q.shape
    E, s = layout.E, q.element_size()
    edges, lanes = E * Z * Bt * nbt, VG * Z * Bt * nbt
    scale_op = int(rule.scale != 1.0)
    tag = f"flagship B={FLAGSHIP_BATCH} Minsumbf16"
    init = fused_var(None, q, layout, rule)
    hold(worst, "fused_var", tag, init, fused_var_reference(None, q, layout, rule))
    v2c0 = init[0]
    c2v = fused_check(v2c0, layout, rule)
    hold(worst, "fused_check", tag, [c2v], [fused_check_reference(v2c0, layout, rule)])
    v2c, bits = fused_var(c2v, q, layout, rule)
    hold(worst, "fused_var", tag, [v2c, bits], fused_var_reference(c2v, q, layout, rule))
    # frame 0 of every other tile set to the all-zero codeword, which
    # satisfies every check: the syndrome must pass those frames and no other
    mixed = bits.clone()
    mixed[::2, :, :, 0] = 0
    for b in (bits0, bits, mixed):
        flags = fused_syndrome_bits(b, layout)
        hold(worst, "fused_syndrome_bits", f"{tag}, flags", [flags],
             [fused_syndrome_bits_reference(b, layout)])
    passed = flags == 0
    assert passed[::2, 0].all() and int(passed.sum()) == nbt - nbt // 2, \
        "syndrome of the mixed bits"
    frames = nbt * Bt
    newly = freeze_checks(worst, tag, layout, (bits0, bits, mixed, mixed, torch.zeros_like(bits)))
    torch.cuda.synchronize()
    print(f"flooding kernels vs plain: {tag}: fused_var (init and update), "
          f"fused_check and the syndrome's flags (raw, posterior and mixed "
          f"bits: {int(passed.sum())} of {passed.numel()} frames pass) equal; "
          f"fused_syndrome_freeze on one state, raw, posterior, mixed twice and "
          f"all-zero bits ({newly} frames passing for the first time), equal "
          "(tolerance 0)")
    decode_ms = cuda_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 5)
    resident_ms = cuda_ms(lambda: resident_flooding_decode(*tiles, FLAGSHIP_ITERS), 5)
    stream_ms = cuda_ms(lambda: streaming_flooding_decode(*tiles, FLAGSHIP_ITERS), 3)
    plain_ms = event_ms(lambda: resident_flooding_decode_reference(*tiles, FLAGSHIP_ITERS))
    zeros = torch.zeros_like(bits)
    timed = {
        "fused_check": (
            cuda_ms(lambda: fused_check(v2c0, layout, rule), 10),
            cuda_ms(lambda: fused_check_reference(v2c0, layout, rule), 3),
            bound(2 * edges * s, edges * (CHECK_OPS + scale_op)),
        ),
        "fused_var": (
            cuda_ms(lambda: fused_var(c2v, q, layout, rule), 10),
            cuda_ms(lambda: fused_var_reference(c2v, q, layout, rule), 3),
            bound(2 * edges * s + lanes * (s + 1),
                  edges * VAR_EDGE_OPS + lanes * VAR_LANE_OPS),
        ),
        # every frame passing, on a state that converged already (the
        # warm-up call's): every check read, the bits once and an xor an
        # edge lane; conv read, the count written, nothing frozen
        "fused_syndrome_freeze": (
            *freeze_ms(zeros, layout, 10),
            bound(lanes + frames + 4, edges * SYN_OPS),
        ),
    }
    # a streaming iteration's step at 1.0 dB, where no frame passes and the
    # warps stop early (its bound what this data needs read); and every
    # frame passing for the first time: its bits copied to frozen, its
    # iters and conv written besides (conv set to 0 before each launch, a
    # memset, counts in the time)
    early_ms = freeze_ms(bits, layout, 10)[0]
    early_bound = syndrome_bound(bits, layout, fused_syndrome_bits_reference(bits, layout))
    state = freeze_state(bits)

    def every_frame_passes():
        state[1].zero_()
        fused_syndrome_freeze(zeros, *state[:3], 1, state[3], layout)

    all_ms = cuda_ms(every_frame_passes, 10)
    all_bound = bound(2 * lanes + frames * (1 + 1 + 4) + 4, edges * SYN_OPS)
    init_ms = cuda_ms(lambda: fused_var(None, q, layout, rule), 10)
    res_bound, res_by, state_ms, tile_its = flooding_bounds(tiles, iters)
    mbps = 1e-6 * code.k * FLAGSHIP_BATCH / (decode_ms * 1e-3)
    print(f"[{card}] flagship flooding Decoder.decode_batch: {decode_ms:.3f} ms, "
          f"{mbps:.1f} Mbit/s decoded info, {decode_ms / executed:.3f} ms/iter, "
          "median of 5")
    print(f"[{card}] resident_flooding_decode kernel: {resident_ms:.3f} ms "
          f"({resident_ms / executed:.3f} ms/iter); plain version {plain_ms:.3f} ms "
          f"(one run, {plain_ms / executed:.3f} ms/iter); bound {res_bound:.4f} ms by "
          f"{res_by} (inputs and outputs once; {100 * res_bound / resident_ms:.1f}% "
          f"of bound); state-traffic floor {state_ms:.3f} ms ({tile_its} "
          "tile-iterations)")
    print(f"[{card}] streaming flooding path (staged): {stream_ms:.3f} ms "
          f"({stream_ms / executed:.3f} ms/iter, median of 3); fused_var init "
          f"{init_ms:.3f} ms")
    for name, (ms, pms, (bms, by)) in timed.items():
        print(f"[{card}] {name}: {ms:.3f} ms per iteration, plain {pms:.3f} ms, "
              f"bound {bms:.4f} ms by {by} ({100 * bms / ms:.1f}% of bound)")
    print(f"[{card}] fused_syndrome_freeze on the 1.0 dB bits (no frame passes; a warp "
          f"stops once its frames all fail): {early_ms:.3f} ms, bound {early_bound[0]:.2g} "
          f"ms by {early_bound[1]} (what this data needs read; "
          f"{100 * early_bound[0] / early_ms:.1f}% of bound); every frame passing for "
          f"the first time (its bits frozen): {all_ms:.3f} ms, bound {all_bound[0]:.4f} ms "
          f"by {all_bound[1]} ({100 * all_bound[0] / all_ms:.1f}% of bound)")
    flooding_at_working_point(card, dec)
    measured = {"resident_flooding_decode": entry(resident_launches, resident_ms, plain_ms,
                                                  (res_bound, res_by))}
    for name, (ms, pms, b) in timed.items():
        measured[name] = entry(phase_launches[name], ms, pms, b)
    return measured


def flagship_compressed_layered(card, llrs, worst):
    """Path (a): ``Decoder(Code.R1_2, "HLMinsumf32")`` through the
    compressed layered kernel, held against its plain version and the jnp
    twin; the f32 message kernel timed on the same tiles in turns with it
    (the routing's comparison), and both on the bf16 name's tiles."""
    code = Code.R1_2
    dec = Decoder(code, "HLMinsumf32", device="cuda")
    reset_counts()
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
    torch.cuda.synchronize()
    launches = counts()
    assert launches["compressed_layered_decode"] == 1 \
        and launches["resident_layered_decode"] == 0, f"path (a): {launches}"
    args = tile_inputs(dec.lifted, dec.arithmetic, llrs)
    ref = tiles_to_output(
        dec.lifted, *compressed_layered_decode_reference(*args, FLAGSHIP_ITERS),
        FLAGSHIP_BATCH,
    )
    hold(worst, "compressed_layered_decode", "flagship B=1024 HLMinsumf32",
         [out[k] for k in DECODE_KEYS], [ref[k] for k in DECODE_KEYS])
    same_decode(out, plain_layered_decode(dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS),
                "path (a) against the jnp twin")
    iters = out["iterations"]
    executed = int(iters.max())
    print(f"path (a) HLMinsumf32: launches {launches}; output equal to the plain "
          f"version and the jnp twin (tolerance 0); "
          f"{int(out['success'].sum())}/{FLAGSHIP_BATCH} converged, {executed} "
          "iterations executed")
    decode_ms = cuda_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 5)
    kernel_ms, message_ms = pair_ms(
        lambda: compressed_layered_decode(*args, FLAGSHIP_ITERS),
        lambda: resident_layered_decode(*args, FLAGSHIP_ITERS), 5,
    )
    plain_ms = event_ms(lambda: compressed_layered_decode_reference(*args, FLAGSHIP_ITERS))
    bf16 = tile_inputs(dec.lifted, make_arithmetic("HLMinsumbf16")[1], llrs)
    bf16_ms, bf16_message_ms = pair_ms(
        lambda: compressed_layered_decode(*bf16, FLAGSHIP_ITERS),
        lambda: resident_layered_decode(*bf16, FLAGSHIP_ITERS), 5,
    )
    qv0, _, layout, _ = args
    nbt, VG, Z, Bt = qv0.shape
    lanes, edge_tile = VG * Z * Bt * nbt, layout.E * Z * Bt
    tile_its = int(tile_iterations(iters, Bt).sum())
    ops = tile_its * edge_tile * (CHECK_OPS + LAYERED_EXTRA_OPS + SYN_OPS + 1)
    b = bound(lanes * (4 + 1 + 1) + nbt * Bt * 8, ops)
    # per edge lane: sigma read and written, Qv 16 bytes as for the message
    # kernel; per check lane min1 and min2 f32 read and written
    state_ms = 1e3 * tile_its * (edge_tile * 18 + layout.CG * Z * Bt * 16) / HBM_BYTES_PER_S
    mbps = 1e-6 * code.k * FLAGSHIP_BATCH / (decode_ms * 1e-3)
    print(f"[{card}] path (a) HLMinsumf32 Decoder.decode_batch: {decode_ms:.3f} ms, "
          f"{mbps:.1f} Mbit/s decoded info, median of 5")
    print(f"[{card}] compressed_layered_decode kernel (f32): {kernel_ms:.3f} ms; the "
          f"f32 message kernel resident_layered_decode on the same tiles "
          f"{message_ms:.3f} ms (in turns, median of 5 each); plain version "
          f"{plain_ms:.3f} ms (one run); bound {b[0]:.4f} ms by {b[1]} "
          f"({100 * b[0] / kernel_ms:.1f}% of bound); state-traffic floor "
          f"{state_ms:.3f} ms")
    print(f"[{card}] on the HLMinsumbf16 tiles: compressed_layered_decode "
          f"{bf16_ms:.3f} ms, resident_layered_decode {bf16_message_ms:.3f} ms "
          "(in turns, median of 5 each)")
    return {"compressed_layered_decode": entry(
        launches["compressed_layered_decode"], kernel_ms, plain_ms, b)}


def flagship_compressed_flooding(card, llrs, worst):
    """Path (b): ``Decoder(Code.R1_2, "Minsumf32")`` through the compressed
    flooding kernel, held against its plain version; the f32 message
    kernel timed on the same tiles in turns with it, and both on the bf16
    name's tiles."""
    code = Code.R1_2
    dec = Decoder(code, "Minsumf32", device="cuda")
    reset_counts()
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
    torch.cuda.synchronize()
    launches = counts()
    assert launches["compressed_flooding_decode"] == 1 \
        and launches["resident_flooding_decode"] == 0, f"path (b): {launches}"
    args = flooding_tiles(dec.lifted, dec.arithmetic, llrs)
    ref = tiles_to_output(
        dec.lifted, *compressed_flooding_decode_reference(*args, FLAGSHIP_ITERS),
        FLAGSHIP_BATCH,
    )
    hold(worst, "compressed_flooding_decode", "flagship B=1024 Minsumf32",
         [out[k] for k in DECODE_KEYS], [ref[k] for k in DECODE_KEYS])
    message = tiles_to_output(dec.lifted, *resident_flooding_decode(*args, FLAGSHIP_ITERS),
                              FLAGSHIP_BATCH)
    same_decode(out, message, "path (b) against the message kernel")
    iters = out["iterations"]
    executed = int(iters.max())
    print(f"path (b) Minsumf32: launches {launches}; output equal to the plain "
          f"version and the message kernel (tolerance 0); "
          f"{int(out['success'].sum())}/{FLAGSHIP_BATCH} converged, {executed} "
          "iterations executed")
    decode_ms = cuda_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 5)
    kernel_ms, message_ms = pair_ms(
        lambda: compressed_flooding_decode(*args, FLAGSHIP_ITERS),
        lambda: resident_flooding_decode(*args, FLAGSHIP_ITERS), 5,
    )
    plain_ms = event_ms(lambda: compressed_flooding_decode_reference(*args, FLAGSHIP_ITERS))
    bf16 = flooding_tiles(dec.lifted, make_arithmetic("Minsumbf16")[1], llrs)
    bf16_ms, bf16_message_ms = pair_ms(
        lambda: compressed_flooding_decode(*bf16, FLAGSHIP_ITERS),
        lambda: resident_flooding_decode(*bf16, FLAGSHIP_ITERS), 5,
    )
    q, _, layout, rule = args
    nbt, VG, Z, Bt = q.shape
    s = q.element_size()
    lanes, edge_tile, lane_tile = VG * Z * Bt * nbt, layout.E * Z * Bt, VG * Z * Bt
    tile_its = int(tile_iterations(iters, Bt).sum())
    scale_op = int(rule.scale != 1.0)
    ops = tile_its * (edge_tile * (CHECK_OPS + scale_op + VAR_EDGE_OPS + SYN_OPS)
                      + lane_tile * VAR_LANE_OPS)
    b = bound(lanes * (s + 1 + 1) + nbt * Bt * 8, ops)
    # per edge lane: s read by the check and by the syndrome, sigma read and
    # written, sigma, argm and one magnitude gathered by the variable phase;
    # per check lane the state read and written; per variable lane q read
    # and s written
    state_ms = 1e3 * tile_its * (edge_tile * (4 + 4 + 2 + 2 + s)
                                 + layout.CG * Z * Bt * 2 * (2 * s + 1)
                                 + lane_tile * (s + 4)) / HBM_BYTES_PER_S
    mbps = 1e-6 * code.k * FLAGSHIP_BATCH / (decode_ms * 1e-3)
    LIFTED["Minsumf32"] = (out, decode_ms)
    print(f"[{card}] path (b) Minsumf32 Decoder.decode_batch: {decode_ms:.3f} ms, "
          f"{mbps:.1f} Mbit/s decoded info, median of 5")
    print(f"[{card}] compressed_flooding_decode kernel (f32): {kernel_ms:.3f} ms; the "
          f"f32 message kernel resident_flooding_decode on the same tiles "
          f"{message_ms:.3f} ms (in turns, median of 5 each); plain version "
          f"{plain_ms:.3f} ms (one run); bound {b[0]:.4f} ms by {b[1]} "
          f"({100 * b[0] / kernel_ms:.1f}% of bound); state-traffic floor "
          f"{state_ms:.3f} ms")
    print(f"[{card}] on the Minsumbf16 tiles: compressed_flooding_decode "
          f"{bf16_ms:.3f} ms, resident_flooding_decode {bf16_message_ms:.3f} ms "
          "(in turns, median of 5 each)")
    return {"compressed_flooding_decode": entry(
        launches["compressed_flooding_decode"], kernel_ms, plain_ms, b)}


def flagship_streaming_layered(card, llrs, worst, dec):
    """Path (c): ``lifted_layered_decode(..., resident=False)`` on
    HLMinsumbf16, the streaming sweep and the syndrome under staged
    compaction, equal to the resident path; one sweep on the flagship's
    planes held against its plain version and timed."""
    reset_counts()
    stream = lifted_layered_decode(dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS,
                                   resident=False)
    torch.cuda.synchronize()
    launches = counts()
    executed = int(stream["iterations"].max())
    assert launches["fused_layered_iteration"] == executed \
        and launches["fused_syndrome_freeze"] == executed + 1 \
        and launches["resident_layered_decode"] == 0, f"path (c): {launches}"
    same_decode(stream, dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS),
                "path (c) against the resident path")
    print(f"path (c) streaming HLMinsumbf16: launches {launches}; output equal to "
          f"the resident path; {int(stream['success'].sum())}/{FLAGSHIP_BATCH} "
          f"converged, {executed} iterations executed")
    stream_ms, resident_ms = pair_ms(
        lambda: lifted_layered_decode(dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS,
                                      resident=False),
        lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 3,
    )
    qv0, _, layout, rule = tile_inputs(dec.lifted, dec.arithmetic, llrs)
    rcv0 = zero_rcv(qv0, layout, rule)
    tag = "flagship B=1024 HLMinsumbf16, one sweep"
    hold(worst, "fused_layered_iteration", tag,
         fused_layered_iteration(qv0.clone(), rcv0.clone(), layout, rule),
         fused_layered_iteration_reference(qv0.clone(), rcv0.clone(), layout, rule))
    # in place: the timed sweeps go on decoding the same planes
    qv, rcv = qv0.clone(), rcv0.clone()
    sweep_ms = cuda_ms(lambda: fused_layered_iteration(qv, rcv, layout, rule), 10)
    qp, rp = qv0.clone(), rcv0.clone()
    plain_ms = cuda_ms(lambda: fused_layered_iteration_reference(qp, rp, layout, rule), 3)
    nbt, VG, Z, Bt = qv0.shape
    lanes, edges = VG * Z * Bt * nbt, layout.E * Z * Bt * nbt
    s = rcv0.element_size()
    b = bound(lanes * (4 + 4 + 1) + edges * 2 * s,
              edges * (CHECK_OPS + LAYERED_EXTRA_OPS) + lanes * VAR_LANE_OPS)
    # per edge lane: Rcv read and written, Qv read for x and read and
    # written for the update; per variable lane the bits written
    state_ms = 1e3 * (edges * (2 * s + 12) + lanes) / HBM_BYTES_PER_S
    mbps = 1e-6 * Code.R1_2.k * FLAGSHIP_BATCH / (stream_ms * 1e-3)
    print(f"[{card}] path (c) streaming layered lifted_layered_decode: "
          f"{stream_ms:.3f} ms, {mbps:.1f} Mbit/s decoded info; resident "
          f"Decoder.decode_batch {resident_ms:.3f} ms (in turns, median of 3 each)")
    print(f"[{card}] fused_layered_iteration: {sweep_ms:.3f} ms a sweep, plain "
          f"{plain_ms:.3f} ms, bound {b[0]:.4f} ms by {b[1]} "
          f"({100 * b[0] / sweep_ms:.1f}% of bound); state-traffic floor "
          f"{state_ms:.3f} ms")
    return {"fused_layered_iteration": entry(
        launches["fused_layered_iteration"], sweep_ms, plain_ms, b)}


def i8_kernel_and_plain(name):
    """(kernel wrapper, plain version, tiling) of an i8 name's schedule."""
    if name.startswith("HL"):
        return resident_layered_decode_i8, resident_layered_decode_reference, tile_inputs
    return resident_flooding_decode_i8, resident_flooding_decode_reference, flooding_tiles


def i8_checks(graphs, worst):
    """The int8 instances of the message kernels against their plain
    versions on the four test codes, two i8 names a schedule (on 5G BG2
    z=16 with 64 large-magnitude frames besides, where the clips and the
    partial hard limit act), and a partial tile of each schedule through
    the decoders' glue against the CPU; worst differences into ``worst``."""
    cases = [
        ("5G BG2 z=16", 256, 1.3, 10),
        ("DVB-S2 R1_4short", 128, 0.9, 8),
        ("DVB-S2 R1_2", 128, sigma_at(R1_2_RATE, 1.5), 30),
        ("CCSDS C2", 128, 0.49, 8),
    ]
    for label, batch, sigma, iters in cases:
        lg = graphs[label]
        llrs = channel_llrs(lg.n, batch, sigma, seed=5)
        if label == "5G BG2 z=16":
            llrs = torch.cat([llrs, strong_llrs(lg.n, 64, seed=6)])
        for name in I8_LAYERED + I8_FLOODING:
            tag = f"{label} B={llrs.shape[0]} {name}"
            kernel, plain, tiles = i8_kernel_and_plain(name)
            args = tiles(lg, make_arithmetic(name)[1], llrs)
            out = kernel(*args, iters)
            hold(worst, kernel.__name__, tag, out, plain(*args, iters))
            torch.cuda.synchronize()
            print(f"i8 kernels vs plain: {tag}: {kernel.__name__} equal (tolerance 0), "
                  f"{int(out[2].sum())}/{out[2].numel()} converged")
    bg2 = graphs["5G BG2 z=16"]
    llrs = channel_llrs(bg2.n, 130, 1.3, seed=11)
    for name in ("HLMinstarapproxi8", "Aminstari8JonesPartialHardLimitDeg1Clip"):
        kernel = i8_kernel_and_plain(name)[0]
        decode = lifted_layered_decode if name.startswith("HL") else lifted_flooding_decode
        _, arith = make_arithmetic(name)
        before = kernel.launches
        out = decode(bg2, arith, llrs, 10)
        assert kernel.launches == before + 1, f"partial tile {name}: no launch"
        same_decode({k: v.cpu() for k, v in out.items()},
                    decode(bg2, arith, llrs.cpu(), 10), f"partial tile {name}")
        print(f"i8 kernels vs plain: 5G BG2 z=16 B=130 (partial tile) {name}: "
              f"{int(out['success'].sum())}/130 converged; the kernel and the plain "
              "version on the CPU equal")


def i8_step_checks():
    """The i8 rules' word steps on the card (``fused_bp2.i8_steps``: the
    correction table, both families' folds, the partial hard limit of
    csrc/i8.cuh) on every byte pair in [0, 127]^2, four frames a word, each
    frame's byte through its own permutation of the pairs, against the
    plain rules' value of each byte (tolerance 0)."""
    a = torch.arange(128, dtype=torch.int32).repeat_interleave(128)
    b = torch.arange(128, dtype=torch.int32).repeat(128)
    g = torch.Generator().manual_seed(0)
    perms = [torch.randperm(a.numel(), generator=g) for _ in range(4)]
    wa = sum(a[p] << 8 * f for f, p in enumerate(perms))
    wb = sum(b[p] << 8 * f for f, p in enumerate(perms))
    out = i8_steps(wa.cuda(), wb.cuda())
    torch.cuda.synchronize()
    ref = i8_steps_reference(wa, wb)
    for s, step in enumerate(I8_STEPS):
        # each byte of the words: differences per frame, not per word
        diff = max(int(((out[s].cpu() >> 8 * f & 0xFF) - (ref[s] >> 8 * f & 0xFF)).abs().max())
                   for f in range(4))
        assert diff == 0, f"i8 step {step} differs from the plain rules"
    print(f"i8 word steps vs plain rules: {', '.join(I8_STEPS)} on all {a.numel()} byte "
          "pairs in [0, 127]^2, four frames a word: equal (tolerance 0)")


def float_kernel_and_plain(name):
    """(kernel wrapper, plain version, tiling) of a float name's schedule."""
    if name.startswith("HL"):
        return resident_layered_decode_float, resident_layered_decode_reference, tile_inputs
    return resident_flooding_decode_float, resident_flooding_decode_reference, flooding_tiles


def float_checks(graphs, worst):
    """The float-rule instances of the message kernels against their plain
    versions on the four test codes, all 16 float names (on 5G BG2 z=16
    with 64 large-magnitude frames besides; R1_2 at 8 iterations, not 30,
    to keep the plain layered sweeps' time), and a partial tile through the
    decoders' glue against the CPU (the eight layered names, whose check
    lanes take units of their own, and an f64 flooding one); worst
    differences into ``worst``."""
    cases = [
        ("5G BG2 z=16", 256, 1.3, 10),
        ("DVB-S2 R1_4short", 128, 0.9, 8),
        ("DVB-S2 R1_2", 128, sigma_at(R1_2_RATE, 1.5), 8),
        ("CCSDS C2", 128, sigma_at(C2_RATE, 4.0), 10),
    ]
    for label, batch, sigma, iters in cases:
        lg = graphs[label]
        llrs = channel_llrs(lg.n, batch, sigma, seed=5)
        if label == "5G BG2 z=16":
            llrs = torch.cat([llrs, strong_llrs(lg.n, 64, seed=6)])
        for name in FLOAT_NAMES:
            tag = f"{label} B={llrs.shape[0]} {name}"
            kernel, plain, tiles = float_kernel_and_plain(name)
            args = tiles(lg, make_arithmetic(name)[1], llrs)
            out = kernel(*args, iters)
            hold(worst, kernel.__name__, tag, out, plain(*args, iters))
        torch.cuda.synchronize()
        print(f"float kernels vs plain: {label} B={llrs.shape[0]}: all 16 float names "
              f"equal (tolerance 0), {int(out[2].sum())}/{out[2].numel()} converged "
              f"({name})")
    bg2 = graphs["5G BG2 z=16"]
    llrs = channel_llrs(bg2.n, 130, 1.3, seed=11)
    # every layered float rule (its check lanes' own units) and an f64 flooding one
    for name in ("HLPhif32", "HLTanhf32", "HLMinstarapproxf32", "HLAminstarf32", "HLPhif64",
                 "HLTanhf64", "HLMinstarapproxf64", "HLAminstarf64", "Aminstarf64"):
        kernel = float_kernel_and_plain(name)[0]
        decode = lifted_layered_decode if name.startswith("HL") else lifted_flooding_decode
        _, arith = make_arithmetic(name)
        before = kernel.launches
        out = decode(bg2, arith, llrs, 10)
        assert kernel.launches == before + 1, f"partial tile {name}: no launch"
        same_decode({k: v.cpu() for k, v in out.items()},
                    decode(bg2, arith, llrs.cpu(), 10), f"partial tile {name}")
        print(f"float kernels vs plain: 5G BG2 z=16 B=130 (partial tile) {name}: "
              f"{int(out['success'].sum())}/130 converged; the kernel and the plain "
              "version on the CPU equal")


#: the f32 flooding float names, whose kernels (TPU #4/#5 resident, #7 and #8
#: the phases) take FloatRule<float>'s FloodUnits and VarUnits
F32_FLOODING = ["Phif32", "Tanhf32", "Minstarapproxf32", "Aminstarf32"]


def f32_flooding_checks(graphs, worst):
    """The f32 instances of the resident flooding kernel and of the check
    and variable phases against their plain versions where the other
    checks do not reach them: the 64 bucket (the degree-40 quasi-cyclic
    code, B = 128; MinstarApprox takes 32 at most), a decode and the
    initialisation and two iterations of phases; and a partial tile (5G
    BG2 z=16, B = 130) through the flooding decoder's glue, resident and
    streaming, against the CPU."""
    lg = graphs["QC 3x40 z=16"]
    llrs = channel_llrs(lg.n, 128, 0.45, seed=5)
    for name in F32_FLOODING:
        if name == "Minstarapproxf32":
            continue
        tag = f"QC 3x40 z=16 B=128 {name}"
        q, bits0, layout, rule = flooding_tiles(lg, make_arithmetic(name)[1], llrs)
        out = resident_flooding_decode_float(q, bits0, layout, rule, 10)
        hold(worst, "resident_flooding_decode_float", tag, out,
             resident_flooding_decode_reference(q, bits0, layout, rule, 10))
        v2c, bits = fused_var_float(None, q, layout, rule)
        hold(worst, "fused_var_float", f"{tag}, init", [v2c, bits],
             fused_var_reference(None, q, layout, rule))
        for n in (1, 2):
            c2v = fused_check_float(v2c, layout, rule)
            hold(worst, "fused_check_float", f"{tag}, check {n}", [c2v],
                 [fused_check_reference(v2c, layout, rule)])
            v2c, bits = fused_var_float(c2v, q, layout, rule)
            hold(worst, "fused_var_float", f"{tag}, update {n}", [v2c, bits],
                 fused_var_reference(c2v, q, layout, rule))
        torch.cuda.synchronize()
        print(f"f32 flooding instances vs plain: {tag} (bucket 64): the resident decode "
              f"({int(out[2].sum())}/128 converged) and two iterations of phases equal "
              "(tolerance 0)")
    bg2 = graphs["5G BG2 z=16"]
    llrs = channel_llrs(bg2.n, 130, 1.3, seed=11)
    for name in F32_FLOODING:
        _, arith = make_arithmetic(name)
        ref = lifted_flooding_decode(bg2, arith, llrs.cpu(), 10)
        for resident in (True, False):
            before = (resident_flooding_decode_float.launches, fused_check_float.launches)
            out = lifted_flooding_decode(bg2, arith, llrs, 10, resident=resident)
            after = (resident_flooding_decode_float.launches, fused_check_float.launches)
            assert after[0 if resident else 1] > before[0 if resident else 1], \
                f"partial tile {name} resident={resident}: no launch"
            same_decode({k: v.cpu() for k, v in out.items()}, ref,
                        f"partial tile {name} resident={resident}")
        print(f"f32 flooding kernels vs plain: 5G BG2 z=16 B=130 (partial tile) {name}: "
              f"{int(ref['success'].sum())}/130 converged; resident and streaming on the "
              "card equal the CPU's decode")


def streaming_checks(graphs, worst):
    """The i8 and float instances of the streaming kernels against their
    plain versions on the four test codes: for a flooding name the
    initialisation, two check phases and two updates, for a layered name
    one and two sweeps in place; and each name's whole streaming decode
    (staged compaction) against its resident decode. The i8 names of both
    families with the flags that reach the clips and the partial hard
    limit, with 64 large-magnitude frames besides on 5G BG2 z=16; all 16
    float names (CCSDS C2 holds MinstarApprox at degree 32, its cap; R1_2
    at 8 iterations); worst differences into ``worst``."""
    cases = [
        ("5G BG2 z=16", 256, 1.3, 10),
        ("DVB-S2 R1_4short", 128, 0.9, 8),
        ("DVB-S2 R1_2", 128, sigma_at(R1_2_RATE, 1.5), 8),
        ("CCSDS C2", 128, sigma_at(C2_RATE, 4.0), 10),
    ]
    for label, batch, sigma, iters in cases:
        lg = graphs[label]
        llrs = channel_llrs(lg.n, batch, sigma, seed=5)
        if label == "5G BG2 z=16":
            llrs = torch.cat([llrs, strong_llrs(lg.n, 64, seed=6)])
        for name in I8_LAYERED + I8_FLOODING + FLOAT_NAMES:
            tag = f"{label} B={llrs.shape[0]} {name}"
            arith = make_arithmetic(name)[1]
            layered = name.startswith("HL")
            tiles = (tile_inputs if layered else flooding_tiles)(lg, arith, llrs)
            x0, _, layout, rule = tiles
            sweep, check, var = STREAMING["i8" if is_i8(rule) else "float"]
            if layered:
                rcv0 = zero_rcv(x0, layout, rule)
                kernel, plain = (x0.clone(), rcv0.clone()), (x0.clone(), rcv0.clone())
                for n in (1, 2):
                    k = fused_layered_iteration(*kernel, layout, rule)
                    p = fused_layered_iteration_reference(*plain, layout, rule)
                    hold(worst, sweep.__name__, f"{tag}, sweep {n}", k, p)
                    kernel, plain = k[:2], p[:2]
            else:
                v2c, bits = fused_var(None, x0, layout, rule)
                hold(worst, var.__name__, f"{tag}, init", [v2c, bits],
                     fused_var_reference(None, x0, layout, rule))
                for n in (1, 2):
                    c2v = fused_check(v2c, layout, rule)
                    hold(worst, check.__name__, f"{tag}, check {n}", [c2v],
                         [fused_check_reference(v2c, layout, rule)])
                    v2c, bits = fused_var(c2v, x0, layout, rule)
                    hold(worst, var.__name__, f"{tag}, update {n}", [v2c, bits],
                         fused_var_reference(c2v, x0, layout, rule))
            stream = (streaming_layered_decode if layered else streaming_flooding_decode)(
                *tiles, iters)
            resident = (resident_layered_decode if layered else resident_flooding_decode)(
                *tiles, iters)
            assert max_abs_diff(stream, resident) == 0, f"streaming differs: {tag}"
        torch.cuda.synchronize()
        print(f"streaming instances vs plain: {label} B={llrs.shape[0]}: the i8 names "
              f"{I8_LAYERED + I8_FLOODING} and all 16 float names: each phase and sweep "
              "equal (tolerance 0), each streaming decode equals the resident one")


def family_checks(graphs, worst):
    """The resident kernels (message, compressed, int8 and float-rule
    instances, both schedules) against their plain versions on CCSDS AR4JA K=1024 rates
    1/2 and 4/5 (punctured columns; Z = 128 and 32) and 5G BG1 z=16 (check
    degree 19, the 32 bucket), 48 frames at three noise levels each."""
    cases = [
        ("AR4JA K1024 R1_2", (0.75, 0.85, 0.95)),
        ("AR4JA K1024 R4_5", (0.5, 0.6, 0.7)),
        ("5G BG1 z=16", (0.9, 1.0, 1.1)),
    ]
    layered = [("HLMinsumbf16", resident_layered_decode, resident_layered_decode_reference),
               ("HLMinsumf32", compressed_layered_decode, compressed_layered_decode_reference),
               ("HLMinstarapproxi8", resident_layered_decode_i8,
                resident_layered_decode_reference),
               ("HLPhif64", resident_layered_decode_float, resident_layered_decode_reference),
               ("HLMinstarapproxf32", resident_layered_decode_float,
                resident_layered_decode_reference)]
    flooding = [("Minsumbf16", resident_flooding_decode, resident_flooding_decode_reference),
                ("Minsumf32", compressed_flooding_decode, compressed_flooding_decode_reference),
                ("Minstarapproxi8", resident_flooding_decode_i8,
                 resident_flooding_decode_reference),
                ("Phif32", resident_flooding_decode_float, resident_flooding_decode_reference),
                ("Aminstarf64", resident_flooding_decode_float,
                 resident_flooding_decode_reference)]
    for label, sigmas in cases:
        lg = graphs[label]
        llrs = torch.cat([channel_llrs(lg.n, 16, s, seed=7 + i) for i, s in enumerate(sigmas)])
        for tiles, kernels in ((tile_inputs, layered), (flooding_tiles, flooding)):
            for name, kernel, plain in kernels:
                args = tiles(lg, make_arithmetic(name)[1], llrs)
                out = kernel(*args, 8)
                hold(worst, kernel.__name__, f"{label} {name}", out, plain(*args, 8))
                torch.cuda.synchronize()
                print(f"family kernels vs plain: {label} B=48 {name}: {kernel.__name__} "
                      f"equal (tolerance 0), {int(out[2].sum())}/48 converged")


def flagship_i8(card, llrs, worst, name):
    """Main path 4: ``Decoder(Code.R1_2, name)`` for an i8 name, through
    the int8 instance of its schedule's message kernel; held against the
    plain version; its kernel's numbers."""
    code = Code.R1_2
    dec = Decoder(code, name, device="cuda")
    kernel, plain, tiles = i8_kernel_and_plain(name)
    layered = dec.schedule == "layered"
    reset_counts()
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
    torch.cuda.synchronize()
    launches = counts()
    assert launches[kernel.__name__] == 1 and sum(launches.values()) == 1, \
        f"{name} main path: {launches}"
    args = tiles(dec.lifted, dec.arithmetic, llrs)
    ref, plain_ms = timed_once(lambda: plain(*args, FLAGSHIP_ITERS))
    ref = tiles_to_output(dec.lifted, *ref, FLAGSHIP_BATCH)
    hold(worst, kernel.__name__, f"flagship B={FLAGSHIP_BATCH} {name}",
         [out[k] for k in DECODE_KEYS], [ref[k] for k in DECODE_KEYS])
    assert out["codeword"].shape == (FLAGSHIP_BATCH, code.n)
    iters = out["iterations"]
    executed = int(iters.max())
    print(f"flagship {name} decode: launches {launches}; output equal to the plain "
          f"version (tolerance 0); {int(out['success'].sum())}/{FLAGSHIP_BATCH} "
          f"converged, average iterations {float(iters.float().mean()):.2f}, "
          f"{executed} executed")
    decode_ms = cuda_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 5)
    kernel_ms = cuda_ms(lambda: kernel(*args, FLAGSHIP_ITERS), 5)
    q0, _, layout, rule = args
    nbt, VG, Z, Bt = q0.shape
    lanes, edge_tile, lane_tile = VG * Z * Bt * nbt, layout.E * Z * Bt, VG * Z * Bt
    tile_its = int(tile_iterations(iters, Bt).sum())
    ops = Counter({cls: tile_its * Bt * n
                   for cls, n in i8_iteration_ops(layout, rule, layered).items()})
    b = bound_pipes(lanes * (q0.element_size() + 1 + 1) + nbt * Bt * 8, ops)
    folds = tile_its * i8_word_folds(layout, rule)
    if layered:
        # per edge lane: Rcv int8 read and written, Qv int16 read for x,
        # read and written for the update and read for the syndrome
        state = tile_its * edge_tile * 10
    else:
        # per edge lane: the message read and written in each phase, the
        # bit word read by the syndrome; per variable lane q read, the
        # hard bits written
        state = tile_its * (edge_tile * 5 + lane_tile * 2)
    state_ms = 1e3 * state / HBM_BYTES_PER_S
    mbps = 1e-6 * code.k * FLAGSHIP_BATCH / (decode_ms * 1e-3)
    print(f"[{card}] flagship {name} Decoder.decode_batch: {decode_ms:.3f} ms, "
          f"{mbps:.1f} Mbit/s decoded info, {decode_ms / executed:.3f} ms/iter, "
          "median of 5")
    print(f"[{card}] {kernel.__name__} kernel ({name}): {kernel_ms:.3f} ms "
          f"({kernel_ms / executed:.3f} ms/iter, median of 5); plain version "
          f"{plain_ms:.3f} ms (one run); bound {b[0]:.4f} ms by {b[1]} (the {b[2]} "
          f"pipe's; operations by class { {c: f'{n:.4g}' for c, n in sorted(ops.items())} }, "
          f"the word steps at their executed SASS instructions; "
          f"{100 * b[0] / kernel_ms:.1f}% of bound); state-traffic floor {state_ms:.3f} ms "
          f"({100 * state_ms / kernel_ms:.1f}%, {tile_its} tile-iterations, {folds} word "
          f"folds ({i8_folds(rule.kind, 7)[0]}))")
    return {kernel.__name__: entry(launches[kernel.__name__], kernel_ms, plain_ms, b[:2])}


def flagship_float(card, llrs, worst, name, other=True, tag=""):
    """Main path 5: ``Decoder(Code.R1_2)`` (``name`` None: the default,
    Phif64, flooding) or ``Decoder(Code.R1_2, name)``, through the
    float-rule instance of its schedule's message kernel; held against the
    plain version; its kernel's numbers (keyed by the wrapper's name and
    ``tag``); and, with ``other``, the other precision's instance of the
    same kernel on the same LLRs, held and timed beside it."""
    code = Code.R1_2
    dec = Decoder(code, device="cuda") if name is None else Decoder(code, name, device="cuda")
    name = dec.implementation
    kernel, plain, tiles = float_kernel_and_plain(name)
    layered = dec.schedule == "layered"
    reset_counts()
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
    torch.cuda.synchronize()
    launches = counts()
    assert launches[kernel.__name__] == 1 and sum(launches.values()) == 1, \
        f"{name} main path: {launches}"
    assert out["codeword"].shape == (FLAGSHIP_BATCH, code.n)
    iters = out["iterations"]
    executed = int(iters.max())
    decode_ms = cuda_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 5)
    names = [name]
    if other:
        names.append(name[:-3] + ("f32" if name.endswith("f64") else "f64"))
    measured = {}
    for which in names:
        args = tiles(dec.lifted, make_arithmetic(which)[1], llrs)
        ref = []
        plain_ms = event_ms(lambda: ref.append(plain(*args, FLAGSHIP_ITERS)))
        kout = kernel(*args, FLAGSHIP_ITERS)
        hold(worst, kernel.__name__, f"flagship B={FLAGSHIP_BATCH} {which}", kout, ref[0])
        if which == name:
            mine = tiles_to_output(dec.lifted, *kout, FLAGSHIP_BATCH)
            same_decode(out, mine, f"{name}: Decoder against its kernel")
        kernel_ms = cuda_ms(lambda: kernel(*args, FLAGSHIP_ITERS), 5 if which == name else 3)
        q0, _, layout, rule = args
        nbt, VG, Z, Bt = q0.shape
        s = q0.element_size()
        lanes, edge_tile, lane_tile = VG * Z * Bt * nbt, layout.E * Z * Bt, VG * Z * Bt
        kits = kout[1]
        tile_its = int(tile_iterations(kits, Bt).sum())
        per = float_iteration_ops(layout, rule, layered)
        ops = Counter({cls: tile_its * Bt * n for cls, n in per.items()})
        b = bound_pipes(lanes * (s + 1 + 1) + nbt * Bt * 8, ops)
        if layered:
            # per edge lane: Rcv read and written, Qv read for x, read and
            # written for the update and read for the syndrome
            state = tile_its * edge_tile * 6 * s
        else:
            # per edge lane: the message read and written in each phase, the
            # bit word read by the syndrome; per variable lane q read, the
            # hard bits written
            state = tile_its * (edge_tile * (4 * s + 1) + lane_tile * (s + 1))
        state_ms = 1e3 * state / HBM_BYTES_PER_S
        print(f"[{card}] {kernel.__name__} kernel ({which}): {kernel_ms:.3f} ms "
              f"({kernel_ms / max(int(kits.max()), 1):.3f} ms/iter); plain version "
              f"{plain_ms:.3f} ms (one run); bound {b[0]:.4f} ms by {b[1]} (the "
              f"{b[2]} pipe's; operations by class "
              f"{ {cls: f'{n:.4g}' for cls, n in sorted(ops.items())} }, the "
              f"transcendental steps at their fewest executed instructions; "
              f"{100 * b[0] / kernel_ms:.1f}% of bound); state-traffic floor "
              f"{state_ms:.3f} ms "
              f"({100 * state_ms / kernel_ms:.1f}%, {tile_its} tile-iterations); "
              f"mean iterations {float(kits.float().mean()):.2f}, at most "
              f"{int(kits.max())}; output equal to the plain version (tolerance 0)")
        measured[which] = entry(launches[kernel.__name__], kernel_ms, plain_ms, b[:2])
    mbps = 1e-6 * code.k * FLAGSHIP_BATCH / (decode_ms * 1e-3)
    LIFTED[name] = (out, decode_ms)
    print(f"[{card}] flagship {name} Decoder.decode_batch: {decode_ms:.3f} ms, "
          f"{mbps:.1f} Mbit/s decoded info, {decode_ms / executed:.3f} ms/iter, "
          f"median of 5; launches {launches}; "
          f"{int(out['success'].sum())}/{FLAGSHIP_BATCH} converged, average "
          f"iterations {float(iters.float().mean()):.2f}, {executed} at most")
    return {kernel.__name__ + tag: measured[name]}


def flagship_streaming(card, llrs, worst, name, tag=""):
    """Main path 6: the streaming decode (``resident=False``) of an i8 or
    float name on the flagship (``name`` None: ``Decoder(Code.R1_2)``'s
    default, ``Phif64``), through the streaming instances of its family
    (the phases for a flooding name, the sweep for a layered one, and the
    syndrome); equal to the resident decode of the same name bit for bit,
    both timed in turns; each kernel of the path held against its plain
    version on the flagship's tiles and timed a launch, with its bound a
    launch (the phase's part of an iteration's operations), keyed by the
    wrapper's name and ``tag``."""
    code = Code.R1_2
    dec = Decoder(code, device="cuda") if name is None else Decoder(code, name, device="cuda")
    name = dec.implementation
    layered = dec.schedule == "layered"
    decode = lifted_layered_decode if layered else lifted_flooding_decode

    def streaming():
        return decode(dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS, resident=False)

    def resident():
        return dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)

    reset_counts()
    out = streaming()
    torch.cuda.synchronize()
    launches = counts()
    tiles = (tile_inputs if layered else flooding_tiles)(dec.lifted, dec.arithmetic, llrs)
    x0, _, layout, rule = tiles
    i8 = is_i8(rule)
    sweep, check, var = STREAMING["i8" if i8 else "float"]
    executed = int(out["iterations"].max())
    expect = ({sweep.__name__: executed} if layered
              else {check.__name__: executed, var.__name__: executed + 1})
    expect["fused_syndrome_freeze"] = executed + 1
    assert launches == {**dict.fromkeys(launches, 0), **expect}, \
        f"{name} streaming path: {launches}"
    same_decode(out, resident(), f"{name} streaming against resident")
    assert out["codeword"].shape == (FLAGSHIP_BATCH, code.n)
    stream_ms, resident_ms = pair_ms(streaming, resident, 3)
    mbps = 1e-6 * code.k * FLAGSHIP_BATCH / (stream_ms * 1e-3)
    print(f"[{card}] flagship {name} streaming (lifted_{dec.schedule}_decode, "
          f"resident=False): launches {expect}; output equal to the resident decode; "
          f"{int(out['success'].sum())}/{FLAGSHIP_BATCH} converged, {executed} iterations "
          f"executed; {stream_ms:.3f} ms, {mbps:.1f} Mbit/s decoded info; resident "
          f"{resident_ms:.3f} ms (in turns, median of 3 each)")
    return {fn + tag: e for fn, e in
            streaming_kernels(card, worst, name, tiles, layered, expect).items()}


def streaming_kernels(card, worst, name, tiles, layered, expect):
    """Each streaming kernel of a name's path on the flagship's tiles: the
    sweep (layered) or the check and variable phases (flooding) of its
    family's instance, held against its plain version and timed a launch,
    with its bound a launch (the kernel's part of an iteration's
    operations); ``expect`` its launches a decode."""
    x0, _, layout, rule = tiles
    i8 = is_i8(rule)
    sweep, check, var = STREAMING["i8" if i8 else "float"]
    nbt, VG, Z, Bt = x0.shape
    frames, lanes, edges = nbt * Bt, VG * Z * Bt * nbt, layout.E * Z * Bt * nbt
    s = torch.empty((), dtype=rule.storage_dtype).element_size()

    def phase_bound(nbytes, parts):
        """A launch's bound: its bytes, and its parts of an iteration's
        operations on every frame, by class of instruction."""
        per = (i8_iteration_ops if i8 else float_iteration_ops)(layout, rule, layered, parts)
        return bound_pipes(nbytes, Counter({c: frames * n for c, n in per.items()}))

    tag = f"flagship B={FLAGSHIP_BATCH} {name}"
    timed = {}
    if layered:
        rcv0 = zero_rcv(x0, layout, rule)
        hold(worst, sweep.__name__, f"{tag}, one sweep",
             fused_layered_iteration(x0.clone(), rcv0.clone(), layout, rule),
             fused_layered_iteration_reference(x0.clone(), rcv0.clone(), layout, rule))
        # in place: the timed sweeps go on decoding the same planes
        qv, rcv = x0.clone(), rcv0.clone()
        qp, rp = x0.clone(), rcv0.clone()
        # per lane Qv read and written and the bits written, per edge lane
        # Rcv read and written
        timed[sweep] = (cuda_ms(lambda: fused_layered_iteration(qv, rcv, layout, rule), 10),
                        cuda_ms(lambda: fused_layered_iteration_reference(qp, rp, layout, rule),
                                1),
                        phase_bound(lanes * (2 * x0.element_size() + 1) + edges * 2 * s,
                                    ("check", "update")))
        # per edge lane Rcv read and written, Qv read for x and read and
        # written for the update; per lane the bits written
        floor_ms = 1e3 * (edges * (2 * s + 3 * x0.element_size()) + lanes) / HBM_BYTES_PER_S
        print(f"[{card}] {sweep.__name__} ({name}): state-traffic floor {floor_ms:.3f} ms "
              "a sweep")
    else:
        v2c0, bits = fused_var(None, x0, layout, rule)
        hold(worst, var.__name__, f"{tag}, init", [v2c0, bits],
             fused_var_reference(None, x0, layout, rule))
        c2v = fused_check(v2c0, layout, rule)
        hold(worst, check.__name__, tag, [c2v], [fused_check_reference(v2c0, layout, rule)])
        hold(worst, var.__name__, tag, fused_var(c2v, x0, layout, rule),
             fused_var_reference(c2v, x0, layout, rule))
        timed[check] = (cuda_ms(lambda: fused_check(v2c0, layout, rule), 10),
                        cuda_ms(lambda: fused_check_reference(v2c0, layout, rule), 1),
                        phase_bound(2 * edges * s, ("check",)))
        # per edge lane c2v read and v2c written, per lane q read and the
        # bits written
        timed[var] = (cuda_ms(lambda: fused_var(c2v, x0, layout, rule), 10),
                      cuda_ms(lambda: fused_var_reference(c2v, x0, layout, rule), 1),
                      phase_bound(2 * edges * s + lanes * (s + 1), ("update",)))
    measured = {}
    for fn, (ms, plain_ms, (bms, by, pipe)) in timed.items():
        print(f"[{card}] {fn.__name__} ({name}): {ms:.3f} ms a launch (median of 10), "
              f"{expect[fn.__name__]} launches a decode; plain version {plain_ms:.3f} ms "
              f"(one run); bound {bms:.4f} ms by {by} (its operations by the {pipe} "
              f"pipe; {100 * bms / ms:.1f}% of bound); output equal to the plain version "
              "(tolerance 0)")
        measured[fn.__name__] = entry(expect[fn.__name__], ms, plain_ms, (bms, by))
    return measured


def flooding_at_working_point(card, dec):
    """Resident against streaming (staged compaction) and the unstaged
    streaming loop on the flagship at 2.5 dB, where frames converge at
    different iterations and freeze: equal outputs, equal to the plain
    version, and each path's time. Both streaming loops test and freeze
    through ``fused_syndrome_freeze``."""
    llrs = channel_llrs(dec.lifted.n, FLAGSHIP_BATCH, sigma_at(R1_2_RATE, 2.5), seed=0)
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
    tiles = flooding_tiles(dec.lifted, dec.arithmetic, llrs)

    def streaming():
        return lifted_flooding_decode(
            dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS, resident=False
        )

    def unstaged():
        return flooding_loop(*tiles, FLAGSHIP_ITERS, fused_check, fused_var,
                             fused_syndrome_freeze)

    same_decode(out, streaming(), "2.5 dB streaming")
    same_decode(out, tiles_to_output(dec.lifted, *unstaged(), FLAGSHIP_BATCH),
                "2.5 dB unstaged streaming")
    ref = tiles_to_output(
        dec.lifted, *resident_flooding_decode_reference(*tiles, FLAGSHIP_ITERS),
        FLAGSHIP_BATCH,
    )
    same_decode(out, ref, "2.5 dB plain")
    iters = out["iterations"]
    converged = int(out["success"].sum())
    assert 0 < converged, "no frame converged at 2.5 dB"
    resident_ms = cuda_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 5)
    stream_ms, unstaged_ms = pair_ms(streaming, unstaged, 5)
    print(f"[{card}] flagship flooding at 2.5 dB: {converged}/{FLAGSHIP_BATCH} "
          f"converged, average iterations {float(iters.float().mean()):.2f}, "
          f"{int(iters.max())} at most; resident (Decoder.decode_batch), "
          f"streaming with compaction, the unstaged streaming loop and the plain "
          f"version equal; resident {resident_ms:.3f} ms, streaming with "
          f"compaction {stream_ms:.3f} ms, unstaged {unstaged_ms:.3f} ms "
          "(the last two in turns), median of 5")


def layered_at_working_point(card, dec):
    """The layered counterpart of ``flooding_at_working_point``
    (HLMinsumbf16 at 2.5 dB)."""
    llrs = channel_llrs(dec.lifted.n, FLAGSHIP_BATCH, sigma_at(R1_2_RATE, 2.5), seed=0)
    out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
    qv0, bits0, layout, rule = tile_inputs(dec.lifted, dec.arithmetic, llrs)

    def streaming():
        return lifted_layered_decode(
            dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS, resident=False
        )

    def unstaged():
        qv, rcv = qv0.clone(), zero_rcv(qv0, layout, rule)
        return decode_loop(
            bits0, bits0, lambda: fused_layered_iteration(qv, rcv, layout, rule)[2],
            functools.partial(fused_syndrome_freeze, layout=layout), FLAGSHIP_ITERS,
        )

    same_decode(out, streaming(), "layered 2.5 dB streaming")
    same_decode(out, tiles_to_output(dec.lifted, *unstaged(), FLAGSHIP_BATCH),
                "layered 2.5 dB unstaged streaming")
    same_decode(out, plain_layered_decode(dec.lifted, dec.arithmetic, llrs, FLAGSHIP_ITERS),
                "layered 2.5 dB plain")
    iters = out["iterations"]
    converged = int(out["success"].sum())
    assert 0 < converged, "no frame converged at 2.5 dB"
    resident_ms = cuda_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 5)
    stream_ms, unstaged_ms = pair_ms(streaming, unstaged, 5)
    print(f"[{card}] flagship layered at 2.5 dB: {converged}/{FLAGSHIP_BATCH} "
          f"converged, average iterations {float(iters.float().mean()):.2f}, "
          f"{int(iters.max())} at most; resident (Decoder.decode_batch), "
          f"streaming with compaction, the unstaged streaming loop and the plain "
          f"version equal; resident {resident_ms:.3f} ms, streaming with "
          f"compaction {stream_ms:.3f} ms, unstaged {unstaged_ms:.3f} ms "
          "(the last two in turns), median of 5")


def ber_sweep(card, lifted, name, points, iters, high_fer):
    """A two-point BER sweep through BerTestBuilder on the card."""
    test = BerTestBuilder(
        h=Code.R1_2.h(), lifted_graph=lifted, decoder_implementation=name,
        max_frame_errors=2000, max_run_time=3.0, max_iterations=iters,
        ebn0s_db=points, batch_size=FLAGSHIP_BATCH, seed=0, device="cuda",
    ).build()
    low, high = test.run()
    for s in (low, high):
        print(f"[{card}] ber {name} {s.ebn0_db} dB: {s.num_frames} frames, FER "
              f"{s.ldpc.fer:.3e}, BER {s.ldpc.ber:.3e}, average iterations "
              f"{s.average_iterations:.2f}, {s.throughput_mbps:.1f} Mbit/s")
        assert s.num_frames >= FLAGSHIP_BATCH
    assert low.ldpc.fer >= 0.9, f"{name}: FER at {low.ebn0_db} dB is {low.ldpc.fer}"
    assert high.ldpc.fer <= high_fer, f"{name}: FER at {high.ebn0_db} dB is {high.ldpc.fer}"

# -- the generic parity-check path (torch ops: no kernel of the nine) ----------

#: the recorded rows of the JAX package's whole-pipeline runs on the
#: MacKay-Neal (3,6) n = 1024 code (tools/run_results.sh configs 1 and 2)
FER_ROWS = {"Minstarapproxf32": "results/config1_mn_minsum.txt",
            "Phif64": "results/config2_mn_Phif64.txt",
            "Minstarapproxi8": "results/config2_mn_Minstarapproxi8.txt"}
MN_SYS, MN = "results/mn_512_1024_sys.alist", "results/mn_512_1024.alist"
BG1_384 = "results/bench_5g_bg1_384.alist"
#: code -> the noise sigma range of the card-against-CPU frames, which gives
#: a mix of converged and failed frames
GENERIC_SIGMAS = {"5G BG2 z=16": (1.0, 1.6), "AR4JA K1024 R1_2": (0.85, 1.1),
                  "MacKay-Neal n=1024": (0.7, 0.95)}
GENERIC_EXACT = ["Minsumbf16", "Aminstari8JonesPartialHardLimitDeg1Clip", "HLMinsumf32",
                 "HLMinstarapproxi8"]
GENERIC_FLOAT = ["Phif64", "Tanhf32", "HLPhif32", "HLAminstarf64"]


def peak_gib():
    return torch.cuda.max_memory_allocated() / 2**30


def no_kernel_launched(what):
    launched = {k: v for k, v in counts().items() if v}
    assert not launched, f"{what} launched kernels: {launched}"


def generic_flooding(card, llrs, graph):
    """Flooding at full width: ``Decoder(h)`` of DVB-S2 R1_2's H (the
    generic path; no name: ``Phif64``) and ``Decoder(h, "Minsumf32")`` on
    the flagship LLRs, beside the lifted decode of the same name."""
    for name in ("Phif64", "Minsumf32"):
        dec = Decoder(graph, device="cuda") if name == "Phif64" else Decoder(graph, name)
        assert dec.implementation == name and dec.lifted is None
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
        torch.cuda.synchronize()
        no_kernel_launched(f"generic {name}")
        peak = peak_gib()
        # one run after the decode above, the warm-up
        ms = event_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS))
        iters = out["iterations"]
        assert out["codeword"].shape == (FLAGSHIP_BATCH, graph.n)
        if name not in LIFTED:  # a run of this phase alone
            lifted = Decoder(Code.R1_2, name)
            LIFTED[name] = (lifted.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS),
                            cuda_ms(lambda: lifted.decode_batch(
                                llrs, max_iterations=FLAGSHIP_ITERS), 3))
        lifted_out, lifted_ms = LIFTED[name]
        agree = torch.ones(FLAGSHIP_BATCH, dtype=torch.bool, device=llrs.device)
        for key in ("iterations", "success"):
            agree &= out[key] == lifted_out[key]
        agree &= (out["codeword"] == lifted_out["codeword"]).all(dim=1)
        same = int(agree.sum())
        mbps = 1e-6 * Code.R1_2.k * FLAGSHIP_BATCH / (ms * 1e-3)
        print(f"[{card}] generic flooding {name} (DVB-S2 R1_2 H, n = {graph.n}, B = "
              f"{FLAGSHIP_BATCH}, {FLAGSHIP_EBN0} dB, {FLAGSHIP_ITERS} iterations): "
              f"{ms:.3f} ms a decode (one run), {mbps:.1f} Mbit/s, peak "
              f"{peak:.2f} GiB allocated; {int(out['success'].sum())}/{FLAGSHIP_BATCH} "
              f"converged, average iterations {float(iters.float().mean()):.2f}; the "
              f"lifted decode of the same name {lifted_ms:.3f} ms; {same}/"
              f"{FLAGSHIP_BATCH} frames equal to the lifted decode's")


#: the layers of R1_2short's one-check-layer sweep that phase 7 times
SHORT_LAYERS = 1000


def generic_layered(card):
    """Layered at full width: ``Decoder(SparseMatrix.from_alist_file(
    results/bench_5g_bg1_384.alist), name)``, 5G BG1 Z=384, B = 1024,
    1.0 dB; then the first ``SHORT_LAYERS`` layers of a generic layered sweep
    of DVB-S2 R1_2short, whose staircase makes every check a layer, timed."""
    t0 = time.perf_counter()
    h = SparseMatrix.from_alist_file(BG1_384)
    graph = DecodeGraph.from_sparse(h)
    build_s = time.perf_counter() - t0
    k = h.num_cols - h.num_rows
    llrs = channel_llrs(h.num_cols, FLAGSHIP_BATCH, sigma_at(k / h.num_cols, 1.0), seed=1)
    L, R = graph.layers.shape
    for name in ("HLMinsumf32", "HLMinstarapproxi8"):
        dec = Decoder(graph, name)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
        torch.cuda.synchronize()
        no_kernel_launched(f"generic {name}")
        peak = peak_gib()
        # one run after the decode above, the warm-up
        ms = event_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS))
        iters = out["iterations"]
        assert out["codeword"].shape == (FLAGSHIP_BATCH, h.num_cols)
        mbps = 1e-6 * k * FLAGSHIP_BATCH / (ms * 1e-3)
        print(f"[{card}] generic layered {name} (5G BG1 Z=384 alist, n = {h.num_cols}, "
              f"k = {k}, {L} layers of {R} checks, dc_max {graph.dc_max}; B = "
              f"{FLAGSHIP_BATCH}, 1.0 dB, {FLAGSHIP_ITERS} iterations): {ms:.3f} ms a "
              f"decode, {mbps:.1f} Mbit/s, peak {peak:.2f} GiB allocated; "
              f"{int(out['success'].sum())}/{FLAGSHIP_BATCH} converged, average "
              f"iterations {float(iters.float().mean()):.2f}, {int(iters.max())} at most "
              f"(H read and tables built in {build_s:.1f} s on the host)")
    t0 = time.perf_counter()
    graph = DecodeGraph.from_sparse(Code.R1_2short.h())
    build_s = time.perf_counter() - t0
    _, arith = make_arithmetic("HLMinsumf32")
    short = channel_llrs(graph.n, FLAGSHIP_BATCH, sigma_at(4 / 9, 1.0), seed=2)
    # the first SHORT_LAYERS layers of the sweep: every layer costs the same
    # (one check, the same ops), so a slice reads the cost of a layer
    tables = device_layers(graph, short.device)
    part = dataclasses.replace(tables, layer_vars=tables.layer_vars[:SHORT_LAYERS],
                               layer_masks=tables.layer_masks[:SHORT_LAYERS])
    qv = torch.cat([short.T.contiguous(), short.new_zeros((1, FLAGSHIP_BATCH))])
    rcv = torch.zeros((SHORT_LAYERS, tables.rows, tables.dc, FLAGSHIP_BATCH),
                      device=short.device)
    layered_sweep(qv, rcv, part, arith)
    part_ms = event_ms(lambda: layered_sweep(qv, rcv, part, arith))
    L, R = graph.layers.shape
    print(f"[{card}] generic layered sweep HLMinsumf32 on DVB-S2 R1_2short (staircase: "
          f"{L} layers of {R} check): {part_ms:.3f} ms for its first {SHORT_LAYERS} "
          f"layers, {1e3 * part_ms / SHORT_LAYERS:.1f} us a layer, a sweep "
          f"{part_ms * L / SHORT_LAYERS:.1f} ms at that rate, B = {FLAGSHIP_BATCH} (tables "
          f"built in {build_s:.1f} s on the host)")


#: iterations of phase 7's decodes held against the CPU
CPU_ITERS = 10


def generic_card_against_cpu(card):
    """The generic decodes on the card against the same decodes on the CPU,
    B = 64, both schedules, on 5G BG2 z=16, AR4JA K1024 R1_2 and the
    MacKay-Neal alist: min-sum and i8 names bit for bit, float names with
    equal success and iterations on at least 63 of 64 frames; and generic
    Minsumf32 flooding on AR4JA equal to the lifted decode."""
    ar4ja = AR4JACode(AR4JARate.R1_2, AR4JAInfoSize.K1024)
    codes = {"5G BG2 z=16": BaseGraph.BG2.h(16), "AR4JA K1024 R1_2": ar4ja.h(),
             "MacKay-Neal n=1024": SparseMatrix.from_alist_file(MN_SYS)}
    for code, h in codes.items():
        graph = DecodeGraph.from_sparse(h)
        rng = np.random.default_rng(8)
        sigma = np.linspace(*GENERIC_SIGMAS[code], 64)[:, None]
        x = -1.0 + sigma * rng.standard_normal((64, h.num_cols))
        cpu_llrs = torch.from_numpy(((-2.0 / sigma**2) * x).astype(np.float32))
        llrs = cpu_llrs.cuda()
        line = []
        for name in GENERIC_EXACT + GENERIC_FLOAT:
            dev = Decoder(graph, name).decode_batch(llrs, CPU_ITERS)
            cpu = Decoder(graph, name, device="cpu").decode_batch(cpu_llrs, CPU_ITERS)
            if name in GENERIC_EXACT:
                same_decode(cpu, {k: v.cpu() for k, v in dev.items()}, f"{code} {name} card")
                line.append(f"{name} equal ({int(cpu['success'].sum())}/64 converged)")
            else:
                agree = int(((dev["success"].cpu() == cpu["success"])
                             & (dev["iterations"].cpu() == cpu["iterations"])).sum())
                assert agree >= 63, f"{code} {name}: {agree}/64 frames agree"
                line.append(f"{name} {agree}/64")
        print(f"[{card}] generic card against CPU, {code}, B = 64, {CPU_ITERS} iterations: "
              + "; ".join(line))
    llrs = channel_llrs(ar4ja.h().num_cols, 64, 0.85, seed=0)
    generic = Decoder(ar4ja.h(), "Minsumf32").decode_batch(llrs, 10)
    same_decode(generic, Decoder(ar4ja, "Minsumf32").decode_batch(llrs, 10),
                "AR4JA generic Minsumf32 against the lifted decode")
    print(f"[{card}] generic Minsumf32 flooding on AR4JA K1024 R1_2 equal to the lifted "
          f"decode ({int(generic['success'].sum())}/64 converged)")


def run_ber_cli(args):
    """The port's ``ber`` command line in this process; the final row of
    each Eb/N0 point, read from its ``--output-file``, as (Eb/N0, frames,
    frame errors, FER, Mbit/s)."""
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):  # the live rows
            cli.main(["ber", *args, "--device", "cuda", "--output-file", f"{tmp}/rows.txt"])
        with open(f"{tmp}/rows.txt") as f:
            rows = [line.split("|") for line in f.read().splitlines()[2:]]  # past the header
    return [(float(r[0]), int(r[1]), int(r[3]), float(r[6]), float(r[9])) for r in rows]


def recorded_row(path, ebn0):
    """(frames, frame errors) of a recorded ``ber`` table's row."""
    with open(path) as f:
        for r in f:
            cells = r.split("|")
            if len(cells) > 3 and cells[0].strip() == f"{ebn0:.2f}":
                return int(cells[1]), int(cells[3])
    raise KeyError(f"{path}: no row at {ebn0} dB")


def two_proportion_z(a, b):
    (n1, e1), (n2, e2) = a, b
    p = (e1 + e2) / (n1 + n2)
    if p == 0:
        return 0.0  # no error on either side
    return (e1 / n1 - e2 / n2) / np.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))


def generic_fer_parity(card):
    """Whole-pipeline FER parity: the port's ``ber`` on the MacKay-Neal
    alists (configs 1 and 2 of tools/run_results.sh) against the recorded
    rows of the JAX package's runs, |z| <= 3.29; the permutation path on
    the non-systematic alist; and ``ber ccsds-c2``."""
    common = ["--max-iter", "100", "--batch-size", "2048", "--seed", "1",
              "--frame-errors", "150"]
    runs = [(MN_SYS, name, (1.5, 2.0)) for name in FER_ROWS]
    runs.append((MN, "Minstarapproxf32", (2.0,)))
    for alist, name, points in runs:
        t0 = time.perf_counter()
        rows = run_ber_cli([alist, "--decoder", name, "--min-ebn0", str(points[0]),
                               "--max-ebn0", str(points[-1]), "--step-ebn0", "0.5", *common])
        seconds = time.perf_counter() - t0
        assert [r[0] for r in rows] == list(points), rows
        for ebn0, frames, errors, fer, _ in rows:
            ref = recorded_row(FER_ROWS[name], ebn0)
            z = two_proportion_z((frames, errors), ref)
            print(f"[{card}] ber {alist} {name} {ebn0:.2f} dB: FER {fer:.3e} "
                  f"({errors}/{frames}), recorded {ref[1]}/{ref[0]} "
                  f"({FER_ROWS[name]}); z = {z:+.2f} ({seconds:.1f} s for the run)")
            assert abs(z) <= 3.29, f"{alist} {name} {ebn0} dB: z = {z}"
    t0 = time.perf_counter()
    rows = run_ber_cli(["ccsds-c2", "--decoder", "HLMinsumbf16", "--min-ebn0", "3.6",
                           "--max-ebn0", "4.2", "--step-ebn0", "0.6", "--max-iter", "30",
                           "--batch-size", "1024", "--frame-errors", "100",
                           "--max-time", "3s", "--seed", "1"])
    seconds = time.perf_counter() - t0
    (low, _, _, low_fer, _), (high, _, _, high_fer, _) = rows
    print(f"[{card}] ber ccsds-c2 HLMinsumbf16: {low:.2f} dB FER {low_fer:.3e} "
          f"({rows[0][2]}/{rows[0][1]}), {high:.2f} dB FER {high_fer:.3e} "
          f"({rows[1][2]}/{rows[1][1]}) ({seconds:.1f} s for the run)")
    assert low == 3.6 and low_fer >= 0.5, rows
    assert high == 4.2 and high_fer <= 0.01 and rows[1][1] >= 1024, rows


def generic_path(card, llrs):
    """Main path 7, the generic parity-check path (decoder/flooding.py and
    decoder/layered.py: torch ops, no kernel of its own)."""
    t0 = time.perf_counter()
    graph = DecodeGraph.from_sparse(Code.R1_2.h())
    print(f"generic path: DVB-S2 R1_2 DecodeGraph built in "
          f"{time.perf_counter() - t0:.1f} s on the host")
    generic_flooding(card, llrs, graph)
    generic_layered(card)
    generic_card_against_cpu(card)
    generic_fer_parity(card)


# -- the rest of ber: 8PSK, puncturing, interleaving; encode ------------------

#: the DVB-S2 8PSK r=3/5 pipeline of RESULTS.md:410-418 (backwards-read
#: interleaver, Gray 8PSK, exact max-* demap, Minsumbf16, B = 256)
PSK8_ARGS = ["dvbs2:3/5", "--modulation", "8PSK", "--interleaving", "-3",
             "--decoder", "Minsumbf16", "--max-iter", "30", "--seed", "1"]
#: the JAX package's rows of that pipeline, Eb/N0 -> (frames, frame
#: errors): ``JAX_PLATFORMS=cpu python tests/torch_parity.py 3.6 3.7 3.8``
#: on the CPU (seed 1, B = 64, until 100 frame errors or 30 minutes)
PSK8_JAX_ROWS = {3.6: (576, 113), 3.7: (37632, 100), 3.8: (63168, 0)}
#: seconds of each 8PSK Mbit/s run (B = 256 and 1024)
PSK8_RATE_SECONDS = 2
#: config 3 of tools/run_results.sh: AR4JA r=4/5 k=4096, its last block
#: punctured, HLMinstarapproxf32, 60 iterations, B = 1024
CONFIG3_ARGS = ["ccsds:4/5:4096", "--decoder", "HLMinstarapproxf32", "--puncturing",
                "1,1,1,1,1,1,1,1,1,1,0", "--max-iter", "60", "--batch-size", "1024",
                "--seed", "1", "--frame-errors", "100", "--max-time", "120s"]
CONFIG3_ROWS = "results/config3_ccsds_hl.txt"
CONFIG3_PUNCTURING = [True] * 10 + [False]


def psk8_sweep(card):
    """(a) ``ber dvbs2:3/5 --modulation 8PSK --interleaving -3 --decoder
    Minsumbf16``, B = 256: the FER at 3.6, 3.7 and 3.8 dB (100 frame
    errors or 8 s a point) held against the JAX package's rows (|z| <=
    3.29); then the Mbit/s at 4.5 dB for ``PSK8_RATE_SECONDS`` at B = 256
    and 1024."""
    t0 = time.perf_counter()
    # --max-ebn0 3.85: the points are min + i * step for i up to
    # int((max - min) / step), which rounds (3.8 - 3.6) / 0.1 down to 1
    rows = run_ber_cli([*PSK8_ARGS, "--batch-size", "256", "--min-ebn0", "3.6",
                        "--max-ebn0", "3.85", "--step-ebn0", "0.1", "--frame-errors", "100",
                        "--max-time", "8s"])
    seconds = time.perf_counter() - t0
    assert [r[0] for r in rows] == [3.6, 3.7, 3.8], rows
    for ebn0, n, e, fer, mbps in rows:
        ref = PSK8_JAX_ROWS[ebn0]
        z = two_proportion_z((n, e), ref)
        print(f"[{card}] ber dvbs2:3/5 8PSK Minsumbf16, B = 256, {ebn0:.2f} dB: FER "
              f"{fer:.3e} ({e}/{n}), {mbps:.3f} Mbit/s; the JAX package {ref[1]}/{ref[0]}, "
              f"z = {z:+.2f}")
        assert abs(z) <= 3.29, f"8PSK {ebn0} dB: z = {z}"
    print(f"[{card}] ber dvbs2:3/5 8PSK: {seconds:.1f} s for the run")
    for batch in (256, 1024):
        ((ebn0, n, e, fer, mbps),) = run_ber_cli([
            *PSK8_ARGS, "--batch-size", str(batch), "--min-ebn0", "4.5", "--max-ebn0", "4.5",
            "--step-ebn0", "1", "--frame-errors", "1000000000",
            "--max-time", f"{PSK8_RATE_SECONDS}s"])
        print(f"[{card}] ber dvbs2:3/5 8PSK Minsumbf16 at {ebn0:.2f} dB for "
              f"{PSK8_RATE_SECONDS} s, B = "
              f"{batch}: {mbps:.3f} Mbit/s, {n} frames, FER {fer:.3e} ({e}/{n})")
        assert n >= batch and fer <= 0.01


def held_step(card, test, ebn0, worst, kernel, plain, tiles):
    """Step 0 of a ``BerTest``'s first point at ``ebn0`` (the stream
    ``step_generator(seed, 0, 0)``, as ``ber`` draws it): its decode held
    against ``kernel``'s plain version on the step's LLRs, tolerance 0."""
    batch, iters = test.p.batch_size, test.p.max_iterations
    gen = step_generator(test.p.seed, 0, 0, test.device)
    msg = torch.randint(0, 2, (batch, test.k), generator=gen, dtype=torch.uint8,
                        device=test.device)
    llr = test.channel_llrs(test.encode(msg), test.noise_sigma(ebn0), gen)
    out = test.decode(test.graph, test.arithmetic, llr, iters)
    ref = tiles_to_output(test.graph, *plain(*tiles(test.graph, test.arithmetic, llr), iters),
                          batch)
    label = f"{test.p.decoder_implementation} B={batch} {ebn0:.2f} dB ber step"
    err = hold(worst, kernel.__name__, label, [out[k] for k in DECODE_KEYS],
               [ref[k] for k in DECODE_KEYS])
    print(f"[{card}] {label}, n = {test.n_cw}: {kernel.__name__} decode equal to its plain "
          f"version on the step's LLRs (max abs diff {err}), "
          f"{int(out['success'].sum())}/{batch} converged")


def psk8_kernel(card, test, ebn0):
    """The resident flooding kernel (#4/#5 bf16, bucket 16: the benchmark's
    8PSK cells' shape) on the tiles of the 8PSK r=3/5 step at ``ebn0``
    (``held_step``'s LLRs): its time beside its bound and its state-traffic
    floor (``flooding_bounds``)."""
    gen = step_generator(test.p.seed, 0, 0, test.device)
    msg = torch.randint(0, 2, (test.p.batch_size, test.k), generator=gen, dtype=torch.uint8,
                        device=test.device)
    llr = test.channel_llrs(test.encode(msg), test.noise_sigma(ebn0), gen)
    tiles = flooding_tiles(test.graph, test.arithmetic, llr)
    iters = resident_flooding_decode(*tiles, test.p.max_iterations)[1]
    ms = cuda_ms(lambda: resident_flooding_decode(*tiles, test.p.max_iterations), 5)
    b, by, state_ms, tile_its = flooding_bounds(tiles, iters)
    print(f"[{card}] resident_flooding_decode kernel, 8PSK r=3/5 B={test.p.batch_size} "
          f"{ebn0:.2f} dB ber step (bucket 16): {ms:.3f} ms, median of 5; bound {b:.4f} ms by "
          f"{by} ({100 * b / ms:.1f}% of bound); state-traffic floor {state_ms:.3f} ms "
          f"({100 * state_ms / ms:.1f}% of it; {tile_its} tile-iterations)")


def psk8_step_split(card, worst):
    """One B = 1024 step of the 8PSK pipeline at 3.6 and 4.2 dB held
    against the flooding kernel's plain version (``held_step``); then the
    4.2 dB step, on the same stream, with CUDA events between its parts:
    encode; puncture, interleave, modulate, noise, demap and deinterleave
    (``BerTest.channel_llrs``); decode; counters; and the demap alone with
    the memory it takes above what is allocated before it."""
    test = BerTestBuilder(
        h=Code.R3_5.h(), lifted_graph=lifted_graph_for(Code.R3_5),
        modulation=Modulation.PSK8, decoder_implementation="Minsumbf16",
        interleaving_columns=-3, max_iterations=30, batch_size=FLAGSHIP_BATCH, seed=1,
        device="cuda",
    ).build()
    for ebn0 in (3.6, 4.2):
        held_step(card, test, ebn0, worst, resident_flooding_decode,
                  resident_flooding_decode_reference, flooding_tiles)
    psk8_kernel(card, test, 3.6)
    sigma = test.noise_sigma(4.2)

    def step(events):
        gen = step_generator(1, 0, 0, "cuda")
        msg = torch.randint(0, 2, (FLAGSHIP_BATCH, test.k), generator=gen,
                            dtype=torch.uint8, device="cuda")
        events[0].record()
        cw = test.encode(msg)
        events[1].record()
        llr = test.channel_llrs(cw, sigma, gen)
        events[2].record()
        out = test.decode(test.graph, test.arithmetic, llr, test.p.max_iterations)
        events[3].record()
        counters = _frame_counters(msg, out, 0)
        events[4].record()
        torch.cuda.synchronize()
        return counters

    parts = ("encode", "channel (puncture, interleave, modulate, noise, demap, "
             "deinterleave)", "decode", "counters")
    runs = []
    for _ in range(4):  # the first warms up
        events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        counters = step(events)
        runs.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    split = [statistics.median(r[i] for r in runs[1:]) for i in range(4)]
    rx = AwgnChannel.add_noise(test.modulation.modulate(
        test.interleaver.interleave(test.encode(torch.zeros(
            (FLAGSHIP_BATCH, test.k), dtype=torch.uint8, device="cuda")))),
        sigma, step_generator(1, 0, 1, "cuda"))
    demap_ms = cuda_ms(lambda: test.modulation.demodulate(rx, sigma), 3)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    test.modulation.demodulate(rx, sigma)
    torch.cuda.synchronize()
    demap_gib = (torch.cuda.max_memory_allocated() - before) / 2**30
    total = sum(split)
    print(f"[{card}] 8PSK step, DVB-S2 R3_5, B = {FLAGSHIP_BATCH}, 4.2 dB, Minsumbf16, "
          f"median of 3: " + "; ".join(f"{p} {ms:.3f} ms ({100 * ms / total:.1f} %)"
                                       for p, ms in zip(parts, split))
          + f"; the step {total:.3f} ms; the demap alone {demap_ms:.3f} ms "
          f"({100 * demap_ms / total:.1f} % of the step), {demap_gib:.2f} GiB above "
          f"what was allocated before it; {counters['frame_errors']} frame errors")
    assert counters["num_frames"] == FLAGSHIP_BATCH


def config3_parity(card):
    """(b) config 3, AR4JA r=4/5 k=4096 punctured, HLMinstarapproxf32, at
    2.50 and 2.75 dB against the recorded rows (|z| <= 3.29)."""
    t0 = time.perf_counter()
    rows = run_ber_cli([*CONFIG3_ARGS, "--min-ebn0", "2.5", "--max-ebn0", "2.75",
                        "--step-ebn0", "0.25"])
    seconds = time.perf_counter() - t0
    assert [r[0] for r in rows] == [2.5, 2.75], rows
    for ebn0, frames, errors, fer, mbps in rows:
        ref = recorded_row(CONFIG3_ROWS, ebn0)
        z = two_proportion_z((frames, errors), ref)
        print(f"[{card}] ber ccsds:4/5:4096 punctured HLMinstarapproxf32 {ebn0:.2f} dB: FER "
              f"{fer:.3e} ({errors}/{frames}), recorded {ref[1]}/{ref[0]} ({CONFIG3_ROWS}); "
              f"z = {z:+.2f}; {mbps:.3f} Mbit/s ({seconds:.1f} s for the run)")
        assert abs(z) <= 3.29, f"config 3 {ebn0} dB: z = {z}"


def config3_step(card, worst):
    """One B = 1024 step of config 3 at 2.50 and 2.75 dB held against the
    layered kernel's plain version (``held_step``)."""
    h, lifted = cli.resolve_ber_code(CONFIG3_ARGS[0])
    test = BerTestBuilder(
        h=h, lifted_graph=lifted, decoder_implementation="HLMinstarapproxf32",
        puncturing_pattern=CONFIG3_PUNCTURING, max_iterations=60, batch_size=1024, seed=1,
        device="cuda",
    ).build()
    for ebn0 in (2.5, 2.75):
        held_step(card, test, ebn0, worst, resident_layered_decode_float,
                  resident_layered_decode_reference, tile_inputs)


def encode_on_card(card):
    """(c) ``encode`` of 4096 messages of AR4JA r=1/2 k=1024 (the
    reference's example code) with puncturing 1,1,1,1,0 on the card: its
    file equals the one ``--device cpu`` writes, byte for byte."""
    with tempfile.TemporaryDirectory() as tmp:
        alist, msgs = f"{tmp}/ar4ja.alist", f"{tmp}/msgs.bin"
        with open(alist, "w") as f, contextlib.redirect_stdout(f):
            cli.main(["ccsds", "--rate", "1/2", "--block-size", "1024"])
        bits = np.random.default_rng(4).integers(0, 2, 4096 * 1024, dtype=np.uint8)
        with open(msgs, "wb") as f:
            f.write(bits.tobytes())
        written = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            cli.main(["encode", alist, msgs, f"{tmp}/{device}.bin", "1,1,1,1,0",
                      "--device", device])
            seconds = time.perf_counter() - t0
            with open(f"{tmp}/{device}.bin", "rb") as f:
                written[device] = (f.read(), seconds)
    (card_bytes, card_s), (cpu_bytes, cpu_s) = written["cuda"], written["cpu"]
    assert len(card_bytes) == 4096 * 2048 and card_bytes == cpu_bytes
    print(f"[{card}] encode AR4JA r=1/2 k=1024, 4096 messages, puncturing 1,1,1,1,0: "
          f"--device cuda equal to --device cpu byte for byte ({len(card_bytes)} bytes; "
          f"{card_s:.2f} s and {cpu_s:.2f} s, the host's file work included)")


def rest_of_ber(card, worst):
    """Main path 8, the rest of ``ber``: the 8PSK pipeline through the
    flooding bf16 kernel (#4/#5, bucket 16: R3_5's check degree is at most
    11), config 3 through the float MinstarApprox layered kernel (#1,
    bucket 32), and ``encode`` on the card; the launch counts show both
    kernels. Then, outside the counted run, a step of each pipeline held
    against its kernel's plain version, and the 8PSK step's split."""
    reset_counts()
    psk8_sweep(card)
    config3_parity(card)
    encode_on_card(card)
    launched = counts()
    print(f"rest of ber: launches {json.dumps({k: v for k, v in launched.items() if v})}")
    assert launched["resident_flooding_decode"] > 0, launched
    assert launched["resident_layered_decode_float"] > 0, launched
    config3_step(card, worst)
    psk8_step_split(card, worst)


# -- the port's last modules: the plane path, selftest, sharded ber ------------

#: config 5 of tools/run_results.sh: a PEG (wc = 3) alist, Minstarapproxf32,
#: the batch sharded (``--shard``; here a mesh of one), B = 2048
CONFIG5_ARGS = ["results/peg_512_1024_sys.alist", "--decoder", "Minstarapproxf32", "--shard",
                "--batch-size", "2048", "--max-iter", "100", "--frame-errors", "100",
                "--seed", "1"]
CONFIG5_ROWS = "results/config5_peg_sharded.txt"
EXAMPLE = "examples/external_decoder_ber_torch.py"
#: one rank of phase 9's two-rank ``ber`` step: argv rank, port, batch,
#: seed, Eb/N0; both ranks on cuda:0, joined over gloo, the group ended by
#: ``multihost.shutdown`` before the exit
SHARD_WORKER = r"""
import json, sys, time
import torch
from ldpc_toolbox_torch.codes.dvbs2 import Code
from ldpc_toolbox_torch.decoder.lifted import lifted_graph_for
from ldpc_toolbox_torch.ops.resident_layered import resident_layered_decode
from ldpc_toolbox_torch.parallel import default_mesh
from ldpc_toolbox_torch.parallel.multihost import initialize, shutdown
from ldpc_toolbox_torch.simulation import BerTestBuilder
from ldpc_toolbox_torch.simulation.ber import step_generator

rank, port, batch, seed, ebn0 = sys.argv[1:]
rank, batch, seed, ebn0 = int(rank), int(batch), int(seed), float(ebn0)
t0 = time.perf_counter()
initialize(init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
mesh = default_mesh("cuda:0")
test = BerTestBuilder(h=Code.R1_2.h(), lifted_graph=lifted_graph_for(Code.R1_2),
                      decoder_implementation="HLMinsumbf16", max_iterations=30,
                      batch_size=batch, seed=seed, device=mesh.device, mesh=mesh).build()
sigma = test.noise_sigma(ebn0)
counters = test.step(step_generator(seed, 0, 0, mesh.device), sigma)
launches = resident_layered_decode.launches
torch.cuda.synchronize()
t1 = time.perf_counter()
test.step(step_generator(seed, 0, 1, mesh.device), sigma)
torch.cuda.synchronize()
print("SHARD " + json.dumps({"rank": mesh.rank, "device": str(mesh.device),
                             "counters": counters, "launches": launches,
                             "step_ms": 1e3 * (time.perf_counter() - t1),
                             "setup_s": t1 - t0}), flush=True)
shutdown()
"""


def load_example():
    """The external-decoder example as a module, its names registered."""
    spec = importlib.util.spec_from_file_location("external_decoder_ber_torch", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.register()
    return example


def selftest_on_card(card):
    """(a) ``selftest`` through the command line on the card, all 14
    families (B = 128, 8 iterations): the kernel route against the plane
    path; no family may fail."""
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["selftest", "--device", "cuda"])  # exits 1 on a failure
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[{card}] selftest: {line}")
    assert len(lines) == 14 and all(line.startswith("OK  ") for line in lines), lines
    launched = {k: v for k, v in counts().items() if v}
    print(f"[{card}] selftest launches {json.dumps(launched)}")


#: frames of phase 9(b)'s flagship decodes held against the CPU's
CPU_FRAMES = 4


def plane_paths_at_full_width(card, llrs):
    """(b) The flagship on the torch paths: ``Decoder(Code.R1_2,
    "Offsetminsumf32")`` (the example's arithmetic, no kernel rule: the
    plane-gather flooding path) and ``"HLOffsetminsumf32"`` (the plain
    layered path), B = 1024, 1.0 dB, 30 iterations: wall, peak memory, no
    kernel launched, and ``CPU_FRAMES`` frames on the card equal to the CPU's; the
    plane path of ``Minsumf32`` timed in turns with its kernel; and at 2.5
    dB ``Minsumf32`` through its kernel against the plane path under the
    selftest's rule."""
    lg = lifted_graph_for(Code.R1_2)
    for name, path in (("Offsetminsumf32", "plane-gather flooding"),
                       ("HLOffsetminsumf32", "plain layered")):
        dec = Decoder(Code.R1_2, name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        first = time.perf_counter()
        out = dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS)
        torch.cuda.synchronize()
        first = time.perf_counter() - first
        no_kernel_launched(f"{name} on the {path} path")
        peak = peak_gib()
        ms = event_ms(lambda: dec.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS))
        assert out["codeword"].shape == (FLAGSHIP_BATCH, Code.R1_2.n)
        t0 = time.perf_counter()
        cpu = Decoder(Code.R1_2, name, device="cpu").decode_batch(
            llrs[:CPU_FRAMES].cpu(), max_iterations=FLAGSHIP_ITERS)
        cpu_s = time.perf_counter() - t0
        same_decode(cpu, {k: v[:CPU_FRAMES].cpu() for k, v in out.items()},
                    f"{name} card against CPU")
        iters = out["iterations"]
        print(f"[{card}] {name} ({path} path, no kernel launched; DVB-S2 R1_2, B = "
              f"{FLAGSHIP_BATCH}, {FLAGSHIP_EBN0} dB, {FLAGSHIP_ITERS} iterations): "
              f"{ms:.3f} ms a decode (first {1e3 * first:.3f} ms, the tables built), "
              f"{1e-6 * Code.R1_2.k * FLAGSHIP_BATCH / (ms * 1e-3):.1f} Mbit/s, peak "
              f"{peak:.2f} GiB allocated; {int(out['success'].sum())}/{FLAGSHIP_BATCH} "
              f"converged, average iterations {float(iters.float().mean()):.2f}; "
              f"{CPU_FRAMES} frames equal to the CPU's bit for bit (CPU {cpu_s:.1f} s)")
    _, arith = make_arithmetic("Minsumf32")
    kernel = Decoder(Code.R1_2, "Minsumf32")
    plane_ms, kernel_ms = pair_ms(
        lambda: plane_flooding_decode(lg, arith, llrs, FLAGSHIP_ITERS),
        lambda: kernel.decode_batch(llrs, max_iterations=FLAGSHIP_ITERS), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plane_flooding_decode(lg, arith, llrs, FLAGSHIP_ITERS)
    torch.cuda.synchronize()
    print(f"[{card}] Minsumf32 at {FLAGSHIP_EBN0} dB, in turns: the plane-gather path "
          f"{plane_ms:.3f} ms a decode (peak {peak_gib():.2f} GiB allocated), the "
          f"compressed flooding kernel's decode {kernel_ms:.3f} ms "
          f"({plane_ms / kernel_ms:.1f} times)")
    llrs25 = channel_llrs(Code.R1_2.n, FLAGSHIP_BATCH, sigma_at(R1_2_RATE, 2.5), seed=3)
    reset_counts()
    k_out = kernel.decode_batch(llrs25, max_iterations=FLAGSHIP_ITERS)
    launched = counts()["compressed_flooding_decode"]
    p_out = plane_flooding_decode(lg, arith, llrs25, FLAGSHIP_ITERS)
    both = k_out["success"] & p_out["success"]
    assert launched == 1, counts()
    assert torch.equal(k_out["success"], p_out["success"])
    assert torch.equal(k_out["iterations"], p_out["iterations"])
    assert torch.equal(k_out["codeword"][both], p_out["codeword"][both])
    print(f"[{card}] Minsumf32 at 2.5 dB, B = {FLAGSHIP_BATCH}: the compressed flooding "
          f"kernel ({launched} launch) against the plane-gather path: success and "
          f"iterations equal on every frame, the {int(both.sum())} converged frames' "
          f"codewords equal; average iterations "
          f"{float(k_out['iterations'].float().mean()):.2f}")


def config5_sharded(card):
    """(c) Config 5 through ``ber --shard`` (a mesh of one: one process) at
    1.5 and 2.0 dB against its recorded rows, |z| <= 3.29."""
    t0 = time.perf_counter()
    rows = run_ber_cli([*CONFIG5_ARGS, "--min-ebn0", "1.5", "--max-ebn0", "2.0",
                        "--step-ebn0", "0.5"])
    seconds = time.perf_counter() - t0
    assert [r[0] for r in rows] == [1.5, 2.0], rows
    for ebn0, frames, errors, fer, mbps in rows:
        ref = recorded_row(CONFIG5_ROWS, ebn0)
        z = two_proportion_z((frames, errors), ref)
        print(f"[{card}] ber peg_512_1024_sys Minstarapproxf32 --shard {ebn0:.2f} dB: FER "
              f"{fer:.3e} ({errors}/{frames}), recorded {ref[1]}/{ref[0]} "
              f"({CONFIG5_ROWS}); z = {z:+.2f}; {mbps:.3f} Mbit/s ({seconds:.1f} s for "
              f"the run)")
        assert abs(z) <= 3.29, f"config 5 {ebn0} dB: z = {z}"


def two_ranks_on_one_card(card, batch=FLAGSHIP_BATCH, seed=2, ebn0=1.5):
    """(d) One ``HLMinsumbf16`` ``ber`` step of the flagship (B = 1024, 1.5
    dB) sharded over two processes that share the card (gloo, 512 frames a
    rank, the kernels loaded from this run's build): each rank's summed
    counters equal to the unsharded step's in this process."""
    test = BerTestBuilder(h=Code.R1_2.h(), lifted_graph=lifted_graph_for(Code.R1_2),
                          decoder_implementation="HLMinsumbf16", max_iterations=30,
                          batch_size=batch, seed=seed, device="cuda").build()
    sigma = test.noise_sigma(ebn0)
    reset_counts()
    ref = test.step(step_generator(seed, 0, 0, "cuda"), sigma)
    assert counts()["resident_layered_decode"] == 1, counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    test.step(step_generator(seed, 0, 1, "cuda"), sigma)
    torch.cuda.synchronize()
    local_ms = 1e3 * (time.perf_counter() - t0)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": os.getcwd()}
    built = sorted(_build.BUILD_DIR.glob("*.so"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", SHARD_WORKER, str(rank), str(port),
                               str(batch), str(seed), str(ebn0)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for rank in range(2)]
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-3000:]
            results.append(json.loads(out.split("SHARD ", 1)[1]))
    finally:
        for proc in procs:
            proc.kill()
    wall = time.perf_counter() - t0
    assert sorted(_build.BUILD_DIR.glob("*.so")) == built, "a rank built the kernels again"
    for r in results:
        assert r["counters"] == ref, (r, ref)
        assert r["launches"] == 1 and r["device"] == "cuda:0", r
    print(f"[{card}] ber step HLMinsumbf16, DVB-S2 R1_2, B = {batch}, {ebn0} dB, over two "
          f"ranks sharing cuda:0 (gloo, {batch // 2} frames a rank, one resident layered "
          f"launch each): counters {json.dumps(ref)} on both ranks, equal to the unsharded "
          f"step's; a warm step {results[0]['step_ms']:.3f} and {results[1]['step_ms']:.3f} "
          f"ms (the unsharded step {local_ms:.3f} ms); rank set-up "
          f"{results[0]['setup_s']:.1f} and {results[1]['setup_s']:.1f} s, {wall:.1f} s "
          "for the two processes")


def example_on_card(card):
    """(e) The external-decoder example's sweep on the card."""
    buf = io.StringIO()
    argv = sys.argv
    try:
        sys.argv = [EXAMPLE]
        with contextlib.redirect_stdout(buf):
            runpy.run_path(EXAMPLE, run_name="__main__")
    finally:
        sys.argv = argv
    rows = buf.getvalue().splitlines()
    assert [r.split(":")[0] for r in rows] == ["Eb/N0  2.0 dB", "Eb/N0  3.0 dB"], rows
    for row in rows:
        print(f"[{card}] {EXAMPLE}: {row}")


def rest_of_port(card, llrs):
    """Main path 9, the port's last modules: ``selftest``; the plane-gather
    flooding path and the plain layered path at full width for an
    arithmetic without a kernel; config 5 through ``ber --shard``; a
    ``ber`` step over two ranks on the card; the external-decoder
    example."""
    load_example()
    for part in (lambda: selftest_on_card(card), lambda: plane_paths_at_full_width(card, llrs),
                 lambda: config5_sharded(card), lambda: two_ranks_on_one_card(card),
                 lambda: example_on_card(card)):
        t0 = time.perf_counter()
        part()
        print(f"rest of the port: part done in {time.perf_counter() - t0:.1f} s")


# -- phase 10: the probes of the card's own ceilings (tools/prof_*.py) ---------

#: the probes' kernels in the kernels line, by wrapper (a probe with modes a
#: line a mode: ``wrapper:mode``, its tool's first shape): (source, the TPU
#: kernel it replaces)
PROBE_KERNELS = {
    "stream_slabs": ("ldpc_toolbox_torch/csrc/probes.cu", "tools/prof_copybw.py:45"),
    **{f"alu_chain:{m}": ("ldpc_toolbox_torch/csrc/probes.cu", "tools/prof_vpu_peak.py:43")
       for m in vpu_peak.MODES},
    **{f"rotated_gather:{m}": ("ldpc_toolbox_torch/csrc/probes.cu", "tools/prof_roll.py:24")
       for m in roll.MODES},
    "plane_copy": ("ldpc_toolbox_torch/csrc/probes.cu", "tools/prof_v2.py:39"),
    **{f"minsum_planes:{m}": ("ldpc_toolbox_torch/csrc/probes.cu", "tools/prof_v2.py:39")
       for m in v2.MODES[1:]},
    # P5's full is #3's kernel (fused_layered_iteration), in its own line
    **{f"layered_sweep_parts:{v}": ("ldpc_toolbox_torch/csrc/probe_layered.cu",
                                    "tools/prof_layered_variants.py:45")
       for v in layered_variants.VARIANTS if v != "full"},
}
PROBE_WRAPPERS = (copybw.stream_slabs, vpu_peak.alu_chain, roll.rotated_gather, v2.plane_copy,
                  v2.minsum_planes, layered_variants.layered_sweep_parts,
                  fused_layered_iteration)
#: P5's batches: the tool's, and the flagship's (TPU #3's row)
PROBE_BATCHES = (512, 1024)


def seeded_cuda(shape, dtype, seed, scale=1.0):
    """Standard normal values times ``scale`` made on the card from a seed,
    rounded to ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def probe_timed(wrapper, fns, launches, rounds=1):
    """(launches, {name: Chain}) of the chains of each fn of ``fns`` {name:
    fn}, in turns (``probes._kernels.turns``), the probe's wrapper among
    them: a probe's main path, its counts set to 0 just before and read
    just after."""
    for w in PROBE_WRAPPERS:
        w.launches = 0
    found = probe_kernels.turns(fns, launches, rounds)
    n = wrapper.launches
    assert n > 0, f"{wrapper.__name__} was not launched"
    return n, found


def chain_text(chain):
    """A chain's host time a launch and longest device gap, as printed."""
    return f"host {chain.host_ms:.4f} ms a launch, gap {chain.gap_ms:.4f} ms"


def probe_hold(what, out, ref):
    """Fail unless a probe kernel's outputs equal its plain version's;
    returns the difference (0)."""
    err = max_abs_diff(out, ref)
    assert err == 0, f"{what} differs from its plain version"
    return err


def probe_entry(launches, ms, plain_ms, b, err, library_ms=None):
    return {**entry(launches, ms, plain_ms, b), "max_abs_err": err, "library_ms": library_ms}


def probe_copy_stream(card, measured):
    """P1 at the tool's six slab shapes: ``stream_slabs`` in turns with
    ``src + 1``, the plain version and the library call in one."""
    big = torch.zeros(256 * 1024 * 1024, dtype=torch.bfloat16, device="cuda")  # 0.5 GB
    lib_ms = probe_kernels.chain_ms(lambda: big + 1).ms
    rows = {"torch_x_plus_1_0.5GB_gb_s": 2 * big.nbytes / lib_ms / 1e6}
    del big
    for i, (P, Z, Bt, G, dtype) in enumerate(copybw.CONFIGS):
        src = seeded_cuda((G, P, Z, Bt), dtype, 100 + i, scale=300.0)
        ref, plain_ms = timed_once(lambda: copybw.stream_slabs_reference(src))
        err = probe_hold(f"stream_slabs {tuple(src.shape)}", [copybw.stream_slabs(src)], [ref])
        del ref
        launches, found = probe_timed(copybw.stream_slabs, {
            "kernel": lambda: copybw.stream_slabs(src), "src + 1": lambda: src + 1}, 20, 3)
        ms, torch_ms = found["kernel"].ms, found["src + 1"].ms
        gbs = 2 * src.nbytes / ms / 1e6
        tag = f"P={P} Z={Z} Bt={Bt} G={G} {str(dtype)[6:]}"
        rows[tag] = {"ms": ms, "gb_s": gbs, "torch_src_plus_1_ms": torch_ms,
                     "torch_src_plus_1_gb_s": 2 * src.nbytes / torch_ms / 1e6}
        print(f"[{card}] P1 stream {tag}: {ms:.4f} ms, {gbs:.1f} GB/s "
              f"({chain_text(found['kernel'])}); "
              f"torch src + 1 {torch_ms:.4f} ms, {rows[tag]['torch_src_plus_1_gb_s']:.1f} GB/s "
              f"({chain_text(found['src + 1'])}); in turns; equal")
        if i == 0:
            measured["stream_slabs"] = probe_entry(
                launches, ms, plain_ms, bound(2 * src.nbytes, src.numel()), err, torch_ms)
    return rows


def p2_round_instructions():
    """{mode: (instructions, FP32-pipe instructions)} of a P2 round, counted
    from the SASS of the built ``alu_chain_kernel<OP>`` as
    ``vpu_peak.ROUND_MARKS`` says, roll charged add's; and under
    ``roll_loop`` the shuffles and FADDs of roll's kernel at the tool's Z
    (a lane's, a round)."""
    code = sass(_build.library_path("probes"))
    found = {}
    for op, (mode, mark) in enumerate(vpu_peak.ROUND_MARKS.items()):
        kernel = next(v for k, v in code.items() if k.endswith(f"alu_chain_kernel<{op}>"))
        opcodes = [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0] for i in kernel]
        rounds = opcodes.count(mark)
        assert rounds > 0, f"alu_chain_kernel<{op}> has no {mark}"
        fp = [o for o in opcodes if o.startswith("F") and not o.startswith("F2")]
        found[mode] = (len(fp) / rounds, sum(o in vpu_peak.FP32_PIPE_OPCODES for o in fp) / rounds)
    found["roll"] = found["add"]
    t = vpu_peak.ROLL_LANES[vpu_peak.Z]
    kernel = next(v for k, v in code.items()
                  if k.endswith(f"roll_chain_kernel<{vpu_peak.Z}, {t}>"))
    # roll's kernel has its shuffles and FADDs in its round loop alone
    found["roll_loop"] = {op: sum(f" {op}" in f" {i}" for i in kernel) for op in ("SHFL", "FADD")}
    return found


def probe_alu_chain(card, measured):
    """P2: every op at the tool's rounds on ``vpu_peak.PLANES`` planes,
    held against the plain version, fma too (see ``vpu_peak``). The bound:
    a round's instructions (``p2_round_instructions``) at the issue rate,
    or its FP32-pipe ones at that pipe's rate, whichever takes longer."""
    x = vpu_peak.planes(vpu_peak.PLANES)
    rounds = vpu_peak.R * vpu_peak.K
    per_round = p2_round_instructions()
    rows = {"issue_rate_per_s": vpu_peak.ISSUE_RATE,
            "fp32_pipe_per_s": vpu_peak.FP32_PIPE_RATE, "data_sheet_f32_per_s": F32_OPS_PER_S}
    for mode in vpu_peak.MODES:
        ref, plain_ms = timed_once(lambda: vpu_peak.alu_chain_reference(x, mode, rounds))
        err = probe_hold(f"alu_chain {mode}", [vpu_peak.alu_chain(x, mode, rounds)], [ref])
        launches, found = probe_timed(vpu_peak.alu_chain,
                                      {mode: lambda: vpu_peak.alu_chain(x, mode)}, 5)
        ms = found[mode].ms
        rounds_done = x.numel() * rounds
        rate = rounds_done * vpu_peak.OPS[mode] / (ms * 1e-3)
        issued, on_pipe = per_round[mode]
        by_ops = rounds_done * max(issued / vpu_peak.ISSUE_RATE,
                                   on_pipe / vpu_peak.FP32_PIPE_RATE)
        b = max((1e3 * by_ops, "operations"), bound(2 * x.nbytes, 0))
        rows[mode] = {"ops_per_s": rate, "rounds_per_s": rounds_done / (ms * 1e-3),
                      "instructions_a_round": issued, "fp32_pipe_a_round": on_pipe,
                      "bound_ms": b[0]}
        print(f"[{card}] P2 alu chain {mode}: {ms:.3f} ms, {rate / 1e12:.3f} T ops/s "
              f"({vpu_peak.OPS[mode]} an element a round, the tool's count), "
              f"{rounds_done / (ms * 1e-3) / 1e12:.3f} T rounds/s; bound {b[0]:.3f} ms "
              f"({issued:g} instructions a round at the issue rate "
              f"{vpu_peak.ISSUE_RATE / 1e12:.2f} T/s, {on_pipe:g} on the FP32 pipe at "
              f"{vpu_peak.FP32_PIPE_RATE / 1e12:.2f} T/s), {100 * b[0] / ms:.1f} % of it "
              f"({chain_text(found[mode])}); equal")
        if mode == "roll":
            # the kernel's warps (C = 32 / T columns a warp) and their
            # shuffles and FADDs a round: one warp shuffle a clock an SM (32
            # results), one warp instruction a clock a sub-partition
            loop = per_round["roll_loop"]
            warps = -(-x.shape[0] * x.shape[2] // (32 // vpu_peak.ROLL_LANES[vpu_peak.Z]))
            clocks = 132 * 1.98e9 * ms * 1e-3
            shfl = warps * loop["SHFL"] * rounds / clocks
            issue = warps * (loop["SHFL"] + loop["FADD"]) * rounds / (4 * clocks)
            rows[mode].update(shuffle_unit_share=shfl, issue_share_shfl_fadd=issue)
            print(f"[{card}] P2 roll: {loop['SHFL']} shuffles and {loop['FADD']} FADDs a lane "
                  f"a round (SASS), {warps} warps: the shuffle unit (32 results a clock an SM "
                  f"at 1.98 GHz) {100 * shfl:.1f} % busy, the issue slots {100 * issue:.1f} % "
                  "with those alone")
        measured[f"alu_chain:{mode}"] = probe_entry(launches, ms, plain_ms, b, err)
    return rows


def probe_rotated_gather(card, measured):
    """P3: the four modes at the tool's shapes."""
    src, planes, shifts = roll.inputs()
    rows = {}
    for mode in roll.MODES:
        ref, plain_ms = timed_once(
            lambda: roll.rotated_gather_reference(src, planes, shifts, mode))
        err = probe_hold(f"rotated_gather {mode}",
                         [roll.rotated_gather(src, planes, shifts, mode)], [ref])
        launches, found = probe_timed(
            roll.rotated_gather, {mode: lambda: roll.rotated_gather(src, planes, shifts, mode)}, 30)
        ms = found[mode].ms
        nbytes = roll.moved_bytes(ref)
        rows[mode] = {"gb_s": nbytes / ms / 1e6}
        print(f"[{card}] P3 rotated gather {mode}: {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s "
              f"({chain_text(found[mode])}); equal")
        measured[f"rotated_gather:{mode}"] = probe_entry(
            launches, ms, plain_ms, bound(nbytes, ref.numel() * (roll.D - 1)), err)
    return rows


def probe_minsum_writes(card, measured):
    """P4: the copy and the three min-sum modes at the tool's shapes and
    tile widths (B = 512); the copy beside ``Tensor.copy_``."""
    rng = np.random.default_rng(0)
    dest = torch.from_numpy(rng.permutation(v2.P).astype(np.int32)).cuda()
    shifts = torch.from_numpy(rng.integers(0, v2.Z, v2.P).astype(np.int32)).cuda()
    rows = {}
    for bt in (128, 256, 512):
        src = seeded_cuda((v2.B // bt, v2.G, v2.D, v2.Z, bt), torch.bfloat16, bt)
        for mode in (m for m in v2.MODES if bt in v2.TILES[m]):
            if mode == "copy":
                fn, plain = (lambda: v2.plane_copy(src)), (lambda: v2.plane_copy_reference(src))
            else:
                fn = lambda: v2.minsum_planes(src, mode, dest, shifts)  # noqa: E731
                plain = lambda: v2.minsum_planes_reference(src, mode, dest, shifts)  # noqa: E731
            ref, plain_ms = timed_once(plain)
            err = probe_hold(f"P4 {mode} Bt={bt}", [fn()], [ref])
            del ref
            wrapper = v2.plane_copy if mode == "copy" else v2.minsum_planes
            fns = {mode: fn}
            if mode == "copy":
                out = torch.empty_like(src)
                fns["Tensor.copy_"] = lambda: out.copy_(src)  # noqa: B023
            launches, found = probe_timed(wrapper, fns, 30, 3 if mode == "copy" else 1)
            ms = found[mode].ms
            gbs = 2 * src.nbytes / ms / 1e6
            rows[f"{mode} Bt={bt}"] = {"ms": ms, "gb_s": gbs}
            library_ms = None
            if mode == "copy":
                library_ms = found["Tensor.copy_"].ms
                rows[f"{mode} Bt={bt}"].update(copy__ms=library_ms,
                                               copy__gb_s=2 * src.nbytes / library_ms / 1e6)
                del out
            print(f"[{card}] P4 {mode} Bt={bt}: {ms:.4f} ms, {gbs:.1f} GB/s "
                  f"({chain_text(found[mode])})"
                  + (f"; Tensor.copy_ {library_ms:.4f} ms ({chain_text(found['Tensor.copy_'])}), "
                     "in turns" if library_ms else "") + "; equal")
            if bt == 128:
                name = "plane_copy" if mode == "copy" else f"minsum_planes:{mode}"
                # per element: the fold's compare, min, max and selects, the
                # sign's parity and the output's select and negation
                ops = 0 if mode == "copy" else src.numel() * (CHECK_OPS - 1)
                measured[name] = probe_entry(launches, ms, plain_ms, bound(2 * src.nbytes, ops),
                                             err, library_ms)
        del src
    return rows


def probe_layered_sweep(card, measured):
    """P5: each variant's sweep at B = 512 and 1024 on the tool's case
    (DVB-S2 R1_2, ``HLMinsumbf16``), held against its plain version over two
    sweeps; ms a sweep over ``layered_variants.K`` chained sweeps. ``full``
    is ``fused_layered_iteration`` (TPU #3) itself, the others the probe's
    kernel."""
    rows = {}
    for batch in PROBE_BATCHES:
        layout, rule, qv0, rcv0 = layered_variants.case(batch)
        rows[f"B={batch}"] = {}
        nbt, VG, Z, Bt = qv0.shape
        lanes, edges = VG * Z * Bt * nbt, layout.E * Z * Bt * nbt
        rcv_bytes = edges * 2 * rcv0.element_size()
        for variant in layered_variants.VARIANTS:
            mine, plain = (qv0.clone(), rcv0.clone()), (qv0.clone(), rcv0.clone())
            plain_ms = err = 0.0
            for sweep in range(2):
                out = layered_variants.layered_sweep_parts(*mine, layout, rule, variant)
                ref, ms = timed_once(lambda: layered_variants.layered_sweep_parts_reference(
                    *plain, layout, rule, variant))
                plain_ms = plain_ms or ms
                err = max(err, probe_hold(f"P5 {variant} B={batch}, sweep {sweep}", out, ref))
            for w in PROBE_WRAPPERS:
                w.launches = 0
            chain = layered_variants.sweeps_ms(layout, rule, qv0, rcv0, variant)
            ms = chain.ms
            launches = (layered_variants.layered_sweep_parts.launches
                        + fused_layered_iteration.launches)
            want = layered_variants.K + probe_kernels.WARM_UPS
            assert launches == want, f"P5 {variant}: {launches} launches, not {want}"
            rows[f"B={batch}"][variant] = ms
            qv_bytes = lanes * (5 if variant in ("normw", "dmaonly") else 9)
            ops = {"full": CHECK_OPS + LAYERED_EXTRA_OPS, "noroll": CHECK_OPS + LAYERED_EXTRA_OPS,
                   "norule": LAYERED_EXTRA_OPS, "normw": CHECK_OPS + 2, "dmaonly": 0}[variant]
            b = bound(qv_bytes + rcv_bytes, edges * ops + lanes * VAR_LANE_OPS)
            print(f"[{card}] P5 layered sweep {variant} B={batch}: {ms:.4f} ms a sweep "
                  f"(median of {layered_variants.K} chained; {chain_text(chain)}), bound "
                  f"{b[0]:.4f} ms by {b[1]}; equal over two sweeps")
            if batch == FLAGSHIP_BATCH and variant != "full":
                measured[f"layered_sweep_parts:{variant}"] = probe_entry(
                    launches, ms, plain_ms, b, err)
    return rows


def probes(card, measured):
    """Phase 10: the five probes (P1-P5) at their tools' full shapes, each
    kernel held against its plain version and timed; prints the probes
    JSON line's numbers and returns them."""
    found = {"card": card}
    for key, part in (("copy_stream", probe_copy_stream), ("alu_chain", probe_alu_chain),
                      ("rotated_gather", probe_rotated_gather),
                      ("minsum_writes", probe_minsum_writes),
                      ("layered_sweep", probe_layered_sweep)):
        t0 = time.perf_counter()
        found[key] = part(card, measured)
        torch.cuda.empty_cache()
        print(f"probes: {key} done in {time.perf_counter() - t0:.1f} s")
    return found


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    def mark(what):  # the time each part of the run takes, for its budget
        print(f"chip_smoke: {what} done {time.perf_counter() - t_start:.1f} s after the card check")

    build()
    mark("build")
    graphs = test_graphs()
    # keyed by wrapper: the syndrome kernel (#9) has two,
    # fused_syndrome_freeze and fused_syndrome_bits
    worst = dict.fromkeys([fn.__name__ for fn in WRAPPERS], 0.0)
    layered_checks(graphs, worst)
    flooding_checks(graphs, worst)
    compressed_checks(graphs, worst)
    mark("min-sum kernel checks")
    i8_step_checks()
    i8_checks(graphs, worst)
    mark("i8 kernel checks")
    float_checks(graphs, worst)
    mark("float kernel checks")
    f32_flooding_checks(graphs, worst)
    mark("f32 flooding checks")
    streaming_checks(graphs, worst)
    mark("streaming checks")
    family_checks(graphs, worst)
    mark("kernel checks")

    code = Code.R1_2
    llrs = channel_llrs(code.n, FLAGSHIP_BATCH, sigma_at(R1_2_RATE, FLAGSHIP_EBN0), seed=0)
    layered, measured = flagship_layered(card, llrs)
    measured.update(flagship_flooding(card, llrs, worst))
    measured.update(flagship_compressed_layered(card, llrs, worst))
    measured.update(flagship_compressed_flooding(card, llrs, worst))
    measured.update(flagship_streaming_layered(card, llrs, worst, layered))
    for name in ("HLMinstarapproxi8", "Minstarapproxi8"):
        measured.update(flagship_i8(card, llrs, worst, name))
    mark("flagship min-sum and i8 paths")
    measured.update(flagship_float(card, llrs, worst, None, other=False))
    measured.update(flagship_float(card, llrs, worst, "HLPhif32"))
    # the f32 instances of #4/#5, #7 and #8 have a thread map of their own
    measured.update(flagship_float(card, llrs, worst, "Phif32", other=False, tag=":f32"))
    mark("flagship float paths")
    for name in (None, "Minstarapproxi8", "HLPhif32", "HLMinstarapproxi8"):
        measured.update(flagship_streaming(card, llrs, worst, name))
    measured.update(flagship_streaming(card, llrs, worst, "Phif32", tag=":f32"))
    # HLPhif64 both ways, end to end, and the f64 sweep's launches a decode
    # (the kernels line keeps HLPhif32's path for the float sweep)
    flagship_streaming(card, llrs, worst, "HLPhif64")
    mark("flagship paths")
    generic_path(card, llrs)
    mark("generic path")
    rest_of_ber(card, worst)
    mark("rest of ber")
    rest_of_port(card, llrs)
    mark("rest of the port")
    probe_rows = probes(card, measured)
    mark("probes")
    layered_at_working_point(card, layered)
    ber_sweep(card, layered.lifted, "HLMinsumbf16", [0.5, 2.0], FLAGSHIP_ITERS, 0.01)
    ber_sweep(card, layered.lifted, "Minsumbf16", [0.5, 2.5], FLAGSHIP_ITERS, 0.01)
    ber_sweep(card, layered.lifted, "HLMinstarapproxi8", [0.5, 2.0], FLAGSHIP_ITERS, 0.01)
    ber_sweep(card, layered.lifted, "HLPhif32", [0.5, 2.0], FLAGSHIP_ITERS, 0.01)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check")

    print(f"fused_syndrome_freeze max abs diff {worst['fused_syndrome_freeze']}, "
          f"fused_syndrome_bits {worst['fused_syndrome_bits']} (the one syndrome kernel)")
    # #9's max_abs_err covers both wrappers of its kernel
    worst["fused_syndrome_freeze"] = max(worst["fused_syndrome_freeze"],
                                         worst.pop("fused_syndrome_bits"))
    # a probe's entry carries its own max_abs_err and library_ms
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "max_abs_err": worst.get(name.split(":")[0]), "library_ms": None, **measured[name]}
        for name, (source, replaces) in {**KERNELS, **PROBE_KERNELS}.items()
    ]
    print(json.dumps({"probes": probe_rows}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
