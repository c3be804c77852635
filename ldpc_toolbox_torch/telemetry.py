"""Spans and counters at the port's layer boundaries.

``span(name)`` marks a stretch of host code as ``ldpc.<name>`` in a
``torch.profiler`` trace: the span is a row of the same trace as the
device's kernels and copies, on the profiler's one clock, so each device
row and each idle gap can be put down to the layer the host was in. It
opens a ``record_function`` only while a profiler records; otherwise it
returns one shared no-op context, and costs one flag check. Whoever wraps
``BerTest.step`` or ``Decoder.decode_batch`` in ``torch.profiler`` gets
the spans, with no switch.

``counting()`` collects the counts that the program adds with
``add(name, count)``: each is summed on the device, with no wait, and the
totals are read once, as the block ends. Outside such a block ``add``
returns at once and issues no device op.

Spans:

* ``ldpc.generator``: a step's ``SeedSequence`` and ``torch.Generator``
  (``simulation/ber.py`` ``step_generator``);
* ``ldpc.step``: the whole ``BerTest.step``, and in it ``ldpc.draw``,
  ``ldpc.encode``, ``ldpc.channel``, ``ldpc.decode`` and
  ``ldpc.counters``, around each call; ``ldpc.counters.read`` the
  counters' one read to the host (with a mesh, their sum over the ranks
  too);
* inside a kernel decode (``kernel_layered_decode``,
  ``kernel_flooding_decode``): ``ldpc.decode.tiles_in`` (the LLRs to
  tiles), ``ldpc.decode.kernel`` (the resident, compressed or streaming
  decode), ``ldpc.decode.tiles_out`` (the tiles to the decoder's output).
  The plain and generic decodes have only ``BerTest.step``'s
  ``ldpc.decode``.

Counter: ``tile_iterations``, the iterations each tile of BT frames of a
resident or compressed kernel decode ran, summed over the tiles. A tile
stops when its last frame stops, so this is the sum of each tile's
largest iteration count; set against the frames' own iterations it says
how much of the kernel's work went to frames already done. The streaming
and plain forms stop no tile early (they freeze frames between launches)
and add nothing.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

__all__ = ["PREFIX", "add", "counting", "span"]

PREFIX = "ldpc."

_OFF = contextlib.nullcontext()
#: the innermost open ``counting()`` block's sums, None outside one
_OPEN = contextvars.ContextVar("ldpc_counts", default=None)


def span(name: str):
    """A context that marks its block as ``ldpc.<name>`` while a profiler
    records, and does nothing otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def counting():
    """Collects the counts added inside the block (an inner block collects
    its own); yields a dict, name -> Python number, filled from the device
    when the block ends without an exception."""
    sums, totals = {}, {}
    token = _OPEN.set(sums)
    try:
        yield totals
    finally:
        _OPEN.reset(token)
    totals.update((name, total.item()) for name, total in sums.items())


def add(name: str, count) -> None:
    """Adds ``count()``, a tensor, to the open block's ``name``. Outside a
    ``counting()`` block ``count`` is not called."""
    sums = _OPEN.get()
    if sums is None:
        return
    value = count()
    total = sums.get(name)
    sums[name] = value if total is None else total + value
