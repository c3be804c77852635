"""ChaCha8 RNG bit-compatible with the reference's pinned stream.

A copy of ``ldpc_toolbox_tpu.utils.chacha`` (pure Python), kept so that
this package imports nothing of the JAX package;
``tests/test_torch_constructions.py`` holds it to the reference's goldens.

The reference pins ``Rng = ChaCha8Rng`` (rand_chacha 0.9) crate-wide
(reference src/rand.rs:14-19) so that seeded constructions reproduce
exactly.  This module reimplements, in pure Python:

* the ChaCha8 block function and the ``rand_core`` ``BlockRng`` word
  buffering (4 blocks = 64 little-endian u32 words per refill, 64-bit
  block counter in state words 12-13, stream 0 in words 14-15);
* ``SeedableRng::seed_from_u64`` (rand_core 0.9): a PCG32 output
  sequence expands the u64 seed into the 32-byte ChaCha key;
* ``Rng::random_range(..n)`` for ``usize`` operands (rand 0.9
  ``UniformUsize``: sampled through u32 when ``n-1 <= u32::MAX``, else
  u64; widening-multiply method with the unbiasing early-out);
* ``IteratorRandom::choose_multiple`` (reservoir sampling, one
  ``random_range(..i+1+amount)`` per element past the first ``amount``).

Validated against the reference's own golden values:
``Rng::seed_from_u64(42).next_u64() == 12578764544318200737``
(rand.rs doctest) and the MacKay-Neal seed-187 golden alist
(mackay_neal.rs ``small_matrix`` test) — see tests/test_chacha.py.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, TypeVar

__all__ = ["ChaCha8Rng", "choose_multiple"]

T = TypeVar("T")

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF

# "expand 32-byte k"
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)

# BlockRng buffer: rand_chacha generates 4 ChaCha blocks per refill.
_BUF_BLOCKS = 4
_BUF_WORDS = 16 * _BUF_BLOCKS


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK32


def _chacha_block(key_words, counter: int, rounds: int = 8) -> List[int]:
    """One 64-byte ChaCha block -> 16 output u32 words (stream fixed at 0)."""
    s = [
        *_CONSTANTS,
        *key_words,
        counter & _MASK32,
        (counter >> 32) & _MASK32,
        0,
        0,
    ]
    x = list(s)
    for _ in range(rounds // 2):
        for a, b, c, d in ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15)):
            x[a] = (x[a] + x[b]) & _MASK32
            x[d] = _rotl32(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & _MASK32
            x[b] = _rotl32(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & _MASK32
            x[d] = _rotl32(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & _MASK32
            x[b] = _rotl32(x[b] ^ x[c], 7)
        for a, b, c, d in ((0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)):
            x[a] = (x[a] + x[b]) & _MASK32
            x[d] = _rotl32(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & _MASK32
            x[b] = _rotl32(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & _MASK32
            x[d] = _rotl32(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & _MASK32
            x[b] = _rotl32(x[b] ^ x[c], 7)
    return [(xi + si) & _MASK32 for xi, si in zip(x, s)]


class ChaCha8Rng:
    """``rand_chacha::ChaCha8Rng`` word stream + rand 0.9 range sampling."""

    def __init__(self, seed_bytes: bytes):
        assert len(seed_bytes) == 32
        self._key = [
            int.from_bytes(seed_bytes[4 * i : 4 * i + 4], "little") for i in range(8)
        ]
        self._counter = 0  # 64-bit block counter of the NEXT refill
        self._buf: List[int] = []
        self._index = _BUF_WORDS  # force refill on first use

    # -- construction -------------------------------------------------

    @classmethod
    def from_seed(cls, seed_bytes: bytes) -> "ChaCha8Rng":
        return cls(seed_bytes)

    @classmethod
    def seed_from_u64(cls, state: int) -> "ChaCha8Rng":
        """rand_core 0.9 ``SeedableRng::seed_from_u64``: PCG32 key expansion."""
        mul = 6364136223846793005
        inc = 11634580027462260723
        out = bytearray()
        state &= _MASK64
        for _ in range(8):
            state = (state * mul + inc) & _MASK64
            xorshifted = (((state >> 18) ^ state) >> 27) & _MASK32
            rot = state >> 59
            x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _MASK32
            out += x.to_bytes(4, "little")
        return cls(bytes(out))

    # -- BlockRng core ------------------------------------------------

    def _refill(self) -> None:
        self._buf = []
        for _ in range(_BUF_BLOCKS):
            self._buf.extend(_chacha_block(self._key, self._counter))
            self._counter = (self._counter + 1) & _MASK64
        self._index = 0

    def next_u32(self) -> int:
        if self._index >= _BUF_WORDS:
            self._refill()
        w = self._buf[self._index]
        self._index += 1
        return w

    def next_u64(self) -> int:
        """rand_core ``BlockRng::next_u64`` (lo word first, refill-aware)."""
        i = self._index
        if i < _BUF_WORDS - 1:
            self._index += 2
            return self._buf[i] | (self._buf[i + 1] << 32)
        if i >= _BUF_WORDS:
            self._refill()
            self._index = 2
            return self._buf[0] | (self._buf[1] << 32)
        lo = self._buf[_BUF_WORDS - 1]
        self._refill()
        self._index = 1
        return lo | (self._buf[0] << 32)

    # -- rand 0.9 uniform range sampling --------------------------------

    def _sample_single_inclusive(self, high_incl: int, bits: int) -> int:
        """``UniformInt::<uN>::sample_single_inclusive(0, high_incl)``:
        widening multiply with a one-extra-sample unbiasing step."""
        mask = (1 << bits) - 1
        rng_next = self.next_u32 if bits == 32 else self.next_u64
        range_ = (high_incl + 1) & mask
        if range_ == 0:  # full range
            return rng_next()
        prod = rng_next() * range_
        result, lo_order = prod >> bits, prod & mask
        if lo_order > ((-range_) & mask):
            new_hi_order = (rng_next() * range_) >> bits
            result += 1 if (lo_order + new_hi_order) > mask else 0
        return result

    def random_range(self, n: int) -> int:
        """``rng.random_range(..n)`` for a usize operand (rand 0.9
        ``UniformUsize``: u32 sampling path when the range fits)."""
        assert n > 0
        if n - 1 <= _MASK32:
            return self._sample_single_inclusive(n - 1, 32)
        return self._sample_single_inclusive(n - 1, 64)


def choose_multiple(rng: ChaCha8Rng, items: Iterable[T], amount: int) -> List[T]:
    """``IteratorRandom::choose_multiple`` (rand 0.9): reservoir sampling.

    Returns fewer than ``amount`` items if the iterable is shorter.  The
    output order is the reservoir order (NOT the input order) — callers
    that need set semantics must not rely on ordering, exactly as with
    the reference (util.rs:52, mackay_neal.rs:216).
    """
    it: Iterator[T] = iter(items)
    reservoir: List[T] = []
    for _ in range(amount):
        try:
            reservoir.append(next(it))
        except StopIteration:
            return reservoir
    for i, elem in enumerate(it):
        k = rng.random_range(i + 1 + amount)
        if k < amount:
            reservoir[k] = elem
    return reservoir
