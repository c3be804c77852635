"""The port's copies of the host constructions against the reference's
goldens and the JAX package's originals: the ChaCha8 stream
(``utils/chacha.py``, ``utils/rng.py``; the goldens of
tests/test_chacha.py), MacKay-Neal (both fill policies, the girth and
backtrack budgets, the multi-seed search in its process pool) and PEG,
each alist equal to the JAX package's for the same seed."""

import pytest

from ldpc_toolbox_tpu import mackay_neal as jax_mackay_neal
from ldpc_toolbox_tpu import peg as jax_peg
from ldpc_toolbox_tpu.utils import chacha as jax_chacha
from ldpc_toolbox_torch import mackay_neal, peg
from ldpc_toolbox_torch.utils.chacha import ChaCha8Rng, choose_multiple
from ldpc_toolbox_torch.utils.rng import Rng, sort_by_random_min, sort_by_random_sel


def test_seed_from_u64_golden():
    # the reference's rand.rs doctest (rand.rs:6-13)
    assert ChaCha8Rng.seed_from_u64(42).next_u64() == 12578764544318200737


@pytest.mark.parametrize("seed", [0, 3, 7, 2**40 + 5])
def test_stream_matches_jax(seed):
    """next_u32, next_u64 across a refill, random_range and
    choose_multiple draw the JAX package's stream, word for word."""
    a, b = ChaCha8Rng.seed_from_u64(seed), jax_chacha.ChaCha8Rng.seed_from_u64(seed)
    assert [a.next_u32() for _ in range(63)] == [b.next_u32() for _ in range(63)]
    assert [a.next_u64() for _ in range(70)] == [b.next_u64() for _ in range(70)]
    ns = (1, 2, 3, 10, 1000, 2**33, 2**40)
    assert [a.random_range(n) for n in ns] == [b.random_range(n) for n in ns]
    assert choose_multiple(a, range(50), 7) == jax_chacha.choose_multiple(b, range(50), 7)
    rng = ChaCha8Rng.from_seed(bytes(range(32)))
    jrng = jax_chacha.ChaCha8Rng.from_seed(bytes(range(32)))
    assert [rng.next_u32() for _ in range(130)] == [jrng.next_u32() for _ in range(130)]


def test_selection_helpers_goldens():
    # util.rs:99-129
    assert sort_by_random_sel(list(range(10)), 4, lambda x: x, Rng(0)) == [0, 1, 2, 3]
    u = sort_by_random_sel([(j, j // 10) for j in range(100)], 15, lambda t: t[1], Rng(0))
    assert len(u) == 15 and sum(1 for _, x in u if x == 0) == 10
    assert len(sort_by_random_sel([0] * 50, 25, lambda x: x, Rng(0))) == 25
    assert sort_by_random_sel([1, 2], 3, lambda x: x, Rng(0)) is None
    assert choose_multiple(ChaCha8Rng.seed_from_u64(0), range(3), 5) == [0, 1, 2]
    assert sort_by_random_min([3, 1, 2, 1], lambda x: x, Rng(0)) == 1


def test_mackay_neal_golden_alist_seed187():
    # the reference's mackay_neal.rs small_matrix test (Random policy)
    conf = mackay_neal.Config(nrows=4, ncols=8, wr=4, wc=2,
                              fill_policy=mackay_neal.FillPolicy.RANDOM)
    assert conf.run(187).alist() == (
        "8 4\n2 4\n2 2 2 2 2 2 2 2\n4 4 4 4\n"
        "1 3\n2 4\n2 3\n1 4\n1 4\n1 4\n2 3\n2 3\n"
        "1 4 5 6\n2 3 7 8\n1 3 7 8\n2 4 5 6\n"
    )


#: MacKay-Neal configurations: (nrows, ncols, wr, wc, extra, seed)
MN_CASES = [
    (16, 32, 8, 4, {"fill_policy": "UNIFORM"}, 42),
    (8, 16, 4, 2, {"fill_policy": "RANDOM"}, 7),
    (64, 128, 6, 3, {"min_girth": 6, "girth_trials": 10000, "backtrack_cols": 3,
                     "backtrack_trials": 200, "fill_policy": "UNIFORM"}, 2),
]


def _mn_config(module, nrows, ncols, wr, wc, extra):
    extra = dict(extra)
    extra["fill_policy"] = module.FillPolicy[extra["fill_policy"]]
    return module.Config(nrows=nrows, ncols=ncols, wr=wr, wc=wc, **extra)


@pytest.mark.parametrize("case", MN_CASES, ids=["uniform", "random", "girth"])
def test_mackay_neal_matches_jax(case):
    *shape, seed = case
    h = _mn_config(mackay_neal, *shape).run(seed)
    assert h.alist() == _mn_config(jax_mackay_neal, *shape).run(seed).alist()
    if "min_girth" in case[4]:
        assert h.girth() >= 6


def test_mackay_neal_failure_matches_jax():
    """Too few rows for the weights: both raise the same error."""
    errors = []
    for module in (mackay_neal, jax_mackay_neal):
        with pytest.raises(module.MacKayNealError) as e:
            module.Config(nrows=4, ncols=16, wr=2, wc=3).run(0)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "exceeded backtrack trials"


def test_mackay_neal_search_in_processes():
    """The search fans out over a spawn process pool; the seed it finds
    reproduces its matrix, which the JAX package builds for that seed."""
    conf = mackay_neal.Config(nrows=8, ncols=16, wr=4, wc=2,
                              fill_policy=mackay_neal.FillPolicy.RANDOM)
    seed, h = conf.search(3, 4, max_workers=2)
    assert 3 <= seed < 7 and conf.run(seed) == h
    jconf = jax_mackay_neal.Config(nrows=8, ncols=16, wr=4, wc=2,
                                   fill_policy=jax_mackay_neal.FillPolicy.RANDOM)
    assert jconf.run(seed).alist() == h.alist()
    assert conf.search(0, 8, max_workers=1) == (0, conf.run(0))


@pytest.mark.parametrize("shape, seed", [((32, 64, 3), 0), ((12, 24, 3), 3), ((6, 20, 2), 1)])
def test_peg_matches_jax(shape, seed):
    nrows, ncols, wc = shape
    h = peg.Config(nrows=nrows, ncols=ncols, wc=wc).run(seed)
    assert h.alist() == jax_peg.Config(nrows=nrows, ncols=ncols, wc=wc).run(seed).alist()
    assert all(h.col_weight(c) == wc for c in range(ncols))
