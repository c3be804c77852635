"""Plugging an external decoder arithmetic into the port's BER harness.

The reference shows its decoder plug-in surface by extending the
``DecoderImplementation`` enum and reusing the stock BER CLI
(examples/external_decoder_ber.rs:15-82); ``external_decoder_ber.py`` does
the same on the JAX package. On ``ldpc_toolbox_torch`` the surface is the
``DECODER_IMPLEMENTATIONS`` registry: register a name mapping to
(schedule, arithmetic factory) and ``Decoder``, ``BerTestBuilder`` and the
``ber`` command take it. An arithmetic that has no hand-written kernel
decodes on the torch paths: the generic parity-check path for an alist,
the plane-gather flooding path and the plain layered path for the lifted
standards codes.

Run:  python examples/external_decoder_ber_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch

from ldpc_toolbox_torch.decoder.arithmetic import Arithmetic, _loo_sign
from ldpc_toolbox_torch.decoder.factory import DECODER_IMPLEMENTATIONS
from ldpc_toolbox_torch.mackay_neal import Config
from ldpc_toolbox_torch.simulation import BerTestBuilder
from ldpc_toolbox_torch.systematic import parity_to_systematic


class OffsetMinSum(Arithmetic):
    """Offset min-sum: leave-one-out minimum magnitudes reduced by a
    constant offset (a common hardware-friendly alternative to
    normalization)."""

    def __init__(self, offset=0.5, dtype=torch.float32):
        super().__init__(dtype)
        self.offset = offset

    def check_messages(self, x, mask=None):
        """(rows, d, batch) variable messages, an optional (rows, d)
        validity mask -> the (rows, d, batch) check messages."""
        mask_e = None if mask is None else mask[..., None]
        big = torch.tensor(torch.finfo(self.dtype).max, dtype=self.dtype, device=x.device)
        mag = x.abs()
        if mask_e is not None:
            mag = torch.where(mask_e, mag, big)
        min1 = mag.amin(dim=1, keepdim=True)
        idx1 = mag.argmin(dim=1, keepdim=True)  # the first minimum
        onehot = torch.arange(x.shape[1], device=x.device)[None, :, None] == idx1
        min2 = torch.where(onehot, big, mag).amin(dim=1, keepdim=True)
        loo = torch.where(onehot, min2, min1)
        loo = torch.maximum(loo - self.offset, torch.zeros_like(loo))  # the offset
        return _loo_sign(x, mask_e).to(self.dtype) * loo


def register():
    """Make the external arithmetic available under both schedules."""
    DECODER_IMPLEMENTATIONS["Offsetminsumf32"] = ("flooding", lambda: OffsetMinSum())
    DECODER_IMPLEMENTATIONS["HLOffsetminsumf32"] = ("layered", lambda: OffsetMinSum())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device that runs the sweep (default cuda)")
    args = parser.parse_args(argv)
    register()
    h = parity_to_systematic(Config(nrows=128, ncols=256, wr=6, wc=3).run(7))
    test = BerTestBuilder(
        h=h,
        decoder_implementation="Offsetminsumf32",  # the external decoder
        ebn0s_db=[2.0, 3.0],
        max_frame_errors=20,
        max_iterations=30,
        batch_size=128,
        max_run_time=30.0,
        device=args.device,
    ).build()
    for s in test.run():
        print(
            f"Eb/N0 {s.ebn0_db:4.1f} dB: frames={s.num_frames} "
            f"BER={s.ldpc.ber:.2e} FER={s.ldpc.fer:.2e} "
            f"avg_iters={s.average_iterations:.1f}"
        )


if __name__ == "__main__":
    main()
