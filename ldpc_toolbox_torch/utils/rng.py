"""Reproducible host RNG and randomized-selection helpers.

A copy of ``ldpc_toolbox_tpu.utils.rng`` (pure Python), kept so that this
package imports nothing of the JAX package.

The reference pins a crate-wide seedable stream (``Rng = ChaCha8Rng``,
rand.rs:14-19) used by the pseudorandom constructions, plus two
random-tie-breaking selection helpers (util.rs:22-73).

This framework pins the same ChaCha8 stream (``utils/chacha.py``, validated
against the reference's golden values), so seeded constructions consume
bit-identical randomness.  Where the *selection* semantics are fully
specified, outputs are bit-identical to the reference for the same seed:

* the raw ``next_u32``/``next_u64`` stream and ``random_range`` sampling;
* ``choose_multiple`` reservoir selection (mackay_neal.rs Random policy —
  golden seed-187 alist reproduced, see tests/test_chacha.py);
* ``sort_by_random_sel`` whenever the candidate list has <= 20 elements
  (Rust's ``sort_unstable_by`` is a stable insertion sort below 21
  elements, matching Python's stable sort).

Documented divergences (ARCHITECTURE.md "Known divergences"):

* ``sort_by_random_sel`` on > 20 candidates: the reference's pdqsort
  permutes equal-keyed elements in an unspecified (though deterministic)
  order before the random pick, which this framework does not replicate;
* ``sort_by_random_min``: the reference routes the tie-break through
  rand's private ``CoinFlipper`` (variable bit consumption, internal and
  unspecified); this framework uses one ``random_range`` call instead.

Construction randomness never touches the device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, TypeVar

from .chacha import ChaCha8Rng, choose_multiple

__all__ = [
    "Rng",
    "choose_multiple",
    "sort_by_random_sel",
    "sort_by_random_min",
    "compare_none_as_inf",
]

T = TypeVar("T")


def Rng(seed: int) -> ChaCha8Rng:
    """Seedable reproducible generator (framework-wide pin, rand.rs:14-19)."""
    return ChaCha8Rng.seed_from_u64(seed)


def compare_none_as_inf(x: Optional[int]) -> tuple[int, int]:
    """Sort key treating ``None`` as +infinity (util.rs:76-86)."""
    return (1, 0) if x is None else (0, x)


def sort_by_random_sel(
    items: Sequence[T],
    nitems: int,
    key: Callable[[T], object],
    rng: ChaCha8Rng,
) -> Optional[list[T]]:
    """Pick the ``nitems`` smallest elements by ``key`` with random tie-breaks.

    Elements strictly below the cut value are always taken; the remaining
    slots are filled by a reservoir-sampled choice among the elements equal
    to the cut value (util.rs:22-55).  Returns None if not enough items.
    """
    if len(items) < nitems:
        return None
    if nitems == 0:
        return []
    decorated = sorted(items, key=key)
    cut_key = key(decorated[nitems - 1])
    sure = [x for x in decorated if key(x) < cut_key]
    ties = [x for x in decorated if key(x) == cut_key]
    need = nitems - len(sure)
    return sure + choose_multiple(rng, ties, need)


def sort_by_random_min(
    items: Sequence[T],
    key: Callable[[T], object],
    rng: ChaCha8Rng,
) -> Optional[T]:
    """A uniformly random element among those minimizing ``key``
    (util.rs:57-73).  Returns None for an empty sequence."""
    if not items:
        return None
    min_key = min(key(x) for x in items)
    candidates = [x for x in items if key(x) == min_key]
    return candidates[rng.random_range(len(candidates))]
