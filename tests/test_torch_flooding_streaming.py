"""The port's flooding decode on the CPU, both forms, against the JAX
package's streaming flooding decode (``fused=True, resident=False``: its
Pallas phase kernels in interpret mode), bit for bit on all frames."""

import functools

import pytest
import torch

from ldpc_toolbox_torch.decoder import lifted_flooding
from ldpc_toolbox_torch.decoder.factory import make_arithmetic

from torch_parity import (
    FLOODING_CASES,
    FLOODING_DECODERS,
    assert_same_decode,
    jax_flooding_case,
)


@functools.cache
def _case(code, decoder):
    return jax_flooding_case(code, decoder, resident=False)


@pytest.mark.parametrize("resident", [False, True], ids=["streaming", "resident"])
@pytest.mark.parametrize("decoder", FLOODING_DECODERS)
@pytest.mark.parametrize("code", list(FLOODING_CASES))
def test_decode_matches_jax_streaming(code, decoder, resident):
    tlg, x, jout = _case(code, decoder)
    _, ta = make_arithmetic(decoder)
    tout = lifted_flooding.lifted_flooding_decode(
        tlg, ta, torch.from_numpy(x), FLOODING_CASES[code][2], resident=resident
    )
    assert tout["codeword"].dtype == torch.uint8
    assert tout["iterations"].dtype == torch.int32
    assert_same_decode(jout, tout)
