"""Shared helpers of the tests that hold ldpc_toolbox_torch against the JAX
package: the test codes built by each package from its own code modules,
identical inputs made with numpy from a seed, and exact comparison of
decoder outputs."""

import numpy as np
import torch

from ldpc_toolbox_tpu import codes as jax_codes
from ldpc_toolbox_tpu.decoder import lifted as jax_lifted
from ldpc_toolbox_torch import codes as torch_codes
from ldpc_toolbox_torch.decoder import lifted as torch_lifted

# The parity tests run many small ops on small planes; one intra-op thread
# per process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

#: the test codes by name: DVB-S2 normal and short frames, 5G BG2 at
#: Z=16, and CCSDS C2 (Z=511)
CODES = ("R1_2", "R1_4short", "bg2z16", "ccsds-c2")


def code_objects(name, codes):
    """The test code ``name`` from a package's ``codes`` module: a code
    object, or a ``(BaseGraph, Z)`` pair for 5G. Besides ``CODES``: 5G
    ``bg1z16`` and the AR4JA K=1024 codes ``ar4ja-1/2`` and ``ar4ja-4/5``
    (tests/test_torch_families.py)."""
    if name in ("bg2z16", "bg1z16"):
        return getattr(codes.nr5g.BaseGraph, name[:3].upper()), 16
    if name == "ccsds-c2":
        return codes.ccsds.C2Code()
    if name.startswith("ar4ja-"):
        rate = {"1/2": "R1_2", "4/5": "R4_5"}[name[6:]]
        return codes.ccsds.AR4JACode(
            codes.ccsds.AR4JARate[rate], codes.ccsds.AR4JAInfoSize.K1024
        )
    return codes.dvbs2.Code[name]


def parity_check(name, codes):
    """The parity-check matrix of a test code, from a package's codes."""
    obj = code_objects(name, codes)
    return obj[0].h(obj[1]) if isinstance(obj, tuple) else obj.h()


def _lifted(name, codes, lifted):
    obj = code_objects(name, codes)
    if isinstance(obj, tuple):
        bg, z = obj
        return lifted.LiftedGraph.from_sparse(bg.h(z), *lifted.nr5g_maps(bg, z))
    return lifted.lifted_graph_for(obj)


def lifted_graphs(name):
    """(JAX LiftedGraph, port LiftedGraph) of a test code, each built from
    its own package's code objects."""
    return (
        _lifted(name, jax_codes, jax_lifted),
        _lifted(name, torch_codes, torch_lifted),
    )


def llrs(n, batch, sigma, seed):
    """BPSK all-zero-codeword channel LLRs, float32 (batch, n)."""
    rng = np.random.default_rng(seed)
    x = -1.0 + sigma * rng.standard_normal((batch, n))
    return ((-2.0 / sigma**2) * x).astype(np.float32)


def assert_same_decode(jax_out, torch_out):
    """Bit-for-bit equal success, iterations and codewords, with a mix of
    converged and failed frames."""
    s = np.asarray(jax_out["success"])
    np.testing.assert_array_equal(s, torch_out["success"].numpy())
    np.testing.assert_array_equal(
        np.asarray(jax_out["iterations"]), torch_out["iterations"].numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jax_out["codeword"]), torch_out["codeword"].numpy()
    )
    assert 0 < s.sum() < s.size, f"no convergence mix: {s.sum()}/{s.size}"


def strong_llrs(n, batch, seed):
    """Large-magnitude LLRs (6 to 20) with 1 to 6 % of the signs flipped,
    float32 (batch, n): the i8 checks then see magnitudes near 127, where
    the partial hard limit, the Jones clip and the Deg1Clip act."""
    rng = np.random.default_rng(seed)
    mag = rng.uniform(6.0, 20.0, (batch, n))
    flip = rng.random((batch, n)) < rng.uniform(0.01, 0.06, (batch, 1))
    return np.where(flip, -mag, mag).astype(np.float32)


#: the 16 flooding i8 names: both families, each with its 8 variants
I8_NAMES = [
    prefix + "Jones" * j + "PartialHardLimit" * h + "Deg1Clip" * c
    for prefix in ("Minstarapproxi8", "Aminstari8")
    for j in (0, 1)
    for h in (0, 1)
    for c in (0, 1)
]


def as_torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


#: flooding decode cases, code -> (batch, sigma, iterations): each gives a
#: mix of converged and failed frames
FLOODING_CASES = {"bg2z16": (256, 1.3, 8), "R1_4short": (128, 0.85, 6)}
FLOODING_DECODERS = ["Minsumf32", "Minsumbf16", "Normminsumbf16"]


def jax_flooding_case(code, decoder, resident):
    """(port LiftedGraph, LLRs, JAX output) of a flooding case, the JAX side
    through its fused kernels (``fused=True``), resident or streaming."""
    import jax.numpy as jnp

    from ldpc_toolbox_tpu.decoder import factory as jax_factory
    from ldpc_toolbox_tpu.decoder.lifted_flooding import lifted_flooding_decode

    jlg, tlg = lifted_graphs(code)
    batch, sigma, iters = FLOODING_CASES[code]
    x = llrs(tlg.n, batch, sigma, seed=5)
    _, ja = jax_factory.make_arithmetic(decoder)
    out = lifted_flooding_decode(
        jlg, ja, jnp.asarray(x), iters, fused=True, resident=resident,
        compact=False,
    )
    return tlg, x, out


def torch_transcendentals(monkeypatch, module, names=("exp", "log", "log1p", "tanh")):
    """Patch ``module.jnp`` so that its exp, log, log1p and tanh (or the
    functions ``names``: jnp's names, torch's ``atanh`` for ``arctanh``)
    are torch's, through ``jax.pure_callback``: eager and traced code alike
    (a Pallas kernel in interpret mode too) then evaluates them as the
    port's plain versions do. XLA's own CPU transcendentals are other
    approximations, which the float rules' cancellations amplify
    (tests/test_torch_float.py); with torch's on both sides a comparison
    holds the rules' operations, their order and their types."""
    import jax
    import jax.numpy as jnp

    def via(fn):
        def f(x):
            x = jnp.asarray(x)
            return jax.pure_callback(
                lambda a: fn(torch.from_numpy(np.array(a))).numpy(),
                jax.ShapeDtypeStruct(x.shape, x.dtype), x, vmap_method="broadcast_all",
            )
        return f

    class TorchMath:
        def __getattr__(self, name):
            return getattr(jnp, name)

    for name in names:
        fn = getattr(torch, {"arctanh": "atanh"}.get(name, name))
        setattr(TorchMath, name, staticmethod(via(fn)))
    monkeypatch.setattr(module, "jnp", TorchMath())


#: the generic path's test codes from alists (MacKay-Neal and PEG, n =
#: 1024, as ``tools/run_results.sh`` builds them), besides ``parity_check``'s
ALISTS = {
    "mn": "results/mn_512_1024_sys.alist",
    "mn-nonsys": "results/mn_512_1024.alist",
    "peg": "results/peg_512_1024_sys.alist",
}


def generic_h(name, sparse, codes):
    """The parity-check matrix of a generic-path test code, from a
    package's ``sparse`` and ``codes`` modules: an alist of ``ALISTS``, a
    staircase code (``staircase``: m = 48, n = 96, random information
    columns of weight 3 from a seed, then the double diagonal, so that
    every check of the layered schedule is a layer of its own), or a test
    code of ``parity_check``."""
    import pathlib

    if name in ALISTS:
        root = pathlib.Path(__file__).resolve().parent.parent
        return sparse.SparseMatrix.from_alist_file(root / ALISTS[name])
    if name == "staircase":
        m, n = 48, 96
        rng = np.random.default_rng(11)
        h = sparse.SparseMatrix(m, n)
        for c in range(n - m):
            for r in sorted(rng.choice(m, 3, replace=False)):
                h.insert(int(r), c)
        for r in range(m):
            h.insert(r, n - m + r)
            if r:
                h.insert(r, n - m + r - 1)
        return h
    return parity_check(name, codes)


def mixed_llrs(n, batch, seed, sigmas=(0.7, 0.95)):
    """BPSK all-zero-codeword channel LLRs at noise sigma ``sigmas[0]`` to
    ``sigmas[1]`` over the frames, float32 (batch, n); frame 0 has every
    LLR positive, so that its channel bits already satisfy H (iteration
    0)."""
    rng = np.random.default_rng(seed)
    sigma = np.linspace(*sigmas, batch)[:, None]
    x = -1.0 + sigma * rng.standard_normal((batch, n))
    out = ((-2.0 / sigma**2) * x).astype(np.float32)
    out[0] = np.abs(out[0]) + 0.5
    return out


def jax_psk8_row(ebn0_db, batch=64, frame_errors=100, max_seconds=1800.0, seed=1):
    """The JAX package's ``ber`` row of the DVB-S2 8PSK r=3/5 pipeline
    (RESULTS.md:410-418: backwards-read 3-column interleaver, Gray 8PSK,
    exact max-* demap, ``Minsumbf16``, 30 iterations) at one Eb/N0, run on
    the CPU until ``frame_errors`` frame errors or ``max_seconds``: (frames,
    frame errors, average iterations). chip_smoke.py holds the port's
    rows on the card against these (``python tests/torch_parity.py``)."""
    from ldpc_toolbox_tpu.simulation import BerTestBuilder, Modulation

    code = jax_codes.dvbs2.Code.R3_5
    (s,) = BerTestBuilder(
        h=code.h(), lifted_graph=jax_lifted.lifted_graph_for(code),
        modulation=Modulation.PSK8, decoder_implementation="Minsumbf16",
        interleaving_columns=-3, max_iterations=30, ebn0s_db=[ebn0_db],
        batch_size=batch, seed=seed, max_frame_errors=frame_errors,
        max_run_time=max_seconds,
    ).build().run()
    return s.num_frames, s.ldpc.frame_errors, s.average_iterations


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/torch_parity.py 3.6 3.8
    import sys
    import time

    for arg in sys.argv[1:]:
        t0 = time.perf_counter()
        frames, errors, iters = jax_psk8_row(float(arg))
        print(f"{float(arg):.2f} dB: {errors}/{frames} frame errors, average iterations "
              f"{iters:.2f} ({time.perf_counter() - t0:.0f} s on the CPU)", flush=True)
