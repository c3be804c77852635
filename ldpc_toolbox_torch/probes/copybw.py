"""P1: the copy stream, ``out = src + 1`` over G slabs of (P, Z, Bt).

Ports ``tools/prof_copybw.py`` of the JAX package: ``pallas_stream`` (its
TPU kernel streams the slabs through vector memory with double-buffered
DMA in and out) becomes ``stream_slabs``, the kernel
``stream_kernel<T, PlusOne>`` of ``csrc/probes.cu`` (a thread 16 bytes,
blocks in order over the array in one launch; P4's copy is the same
template); ``xla_copy`` (``x + 1`` over 0.5 GB, XLA's own op) stays the
torch op ``src + 1``, which is also the plain version.

    python -m ldpc_toolbox_torch.probes.copybw

prints torch's ``x + 1`` over 0.5 GB, then for each of the tool's six
slab shapes the kernel's and torch's ``src + 1``'s time and GB/s (read
and write), in turns, each a chain of launches timed by
``_kernels.chain_ms`` (the host path out of the window), and the host
time a launch of each.
"""

from __future__ import annotations

import torch

from . import _kernels

__all__ = ["BLOCK_BYTES", "CONFIGS", "main", "stream_slabs", "stream_slabs_reference"]

#: the bytes a block of the copy stream takes (``csrc/probes.cu``: 512
#: threads of 16 bytes; the last block's share shorter)
BLOCK_BYTES = 8192

#: the tool's configurations (P, Z, Bt, G, dtype): the BP kernels' slab
#: (d = 7, Z = 360, Bt = 128) in bf16; Z at 16-row alignment (352, 368);
#: f32; slabs 4 and 16 times as large
CONFIGS = (
    (7, 360, 128, 360, torch.bfloat16),
    (7, 352, 128, 360, torch.bfloat16),
    (7, 368, 128, 360, torch.bfloat16),
    (7, 360, 128, 360, torch.float32),
    (28, 360, 128, 90, torch.bfloat16),
    (112, 360, 128, 23, torch.bfloat16),
)


def stream_slabs(src: torch.Tensor) -> torch.Tensor:
    """``src + 1`` of (G, P, Z, Bt) bf16 or f32 slabs, a new tensor. On a
    CUDA tensor it launches the kernel (the bytes a multiple of 16), on a
    CPU tensor it runs the plain version."""
    if src.device.type == "cpu":
        return stream_slabs_reference(src)
    if src.dim() != 4 or src.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("src must be (G, P, Z, Bt) bf16 or f32")
    if src.nbytes % 16:
        raise ValueError("the slabs' bytes must be a multiple of 16")
    stream = _kernels.on_card("stream_slabs", src)
    out = torch.empty_like(src)
    lib = _kernels.lib()
    err = lib.ldpc_probe_stream(src.data_ptr(), out.data_ptr(), src.nbytes,
                                int(src.dtype == torch.bfloat16), stream)
    _kernels.raise_on(lib, err, "stream_slabs")
    stream_slabs.launches += 1
    return out


#: kernel launches since the count was last set to 0
stream_slabs.launches = 0


def stream_slabs_reference(src: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``stream_slabs`` (any device)."""
    return src + 1


def main():
    print(_kernels.card_line())
    x = torch.zeros(256 * 1024 * 1024, dtype=torch.bfloat16, device="cuda")  # 0.5 GB
    t = _kernels.chain_ms(lambda: x + 1).ms
    print(f"torch x+1 0.5GB    : {t:7.2f} ms  {2 * x.nbytes / t / 1e6:6.1f} GB/s", flush=True)
    del x
    for P, Z, Bt, G, dtype in CONFIGS:
        src = torch.zeros((G, P, Z, Bt), dtype=dtype, device="cuda")
        slab = src.nbytes // G
        found = _kernels.turns({"kernel": lambda: stream_slabs(src), "torch": lambda: src + 1})
        kernel, plain = found["kernel"], found["torch"]
        print(f"stream P={P:4d} Z={Z} Bt={Bt} {str(dtype)[6:]:8s} slab={slab / 1024:7.0f}KB "
              f"G={G:5d}: {kernel.ms:7.4f} ms {2 * src.nbytes / kernel.ms / 1e6:6.1f} GB/s "
              f"(torch src+1 {plain.ms:7.4f} ms {2 * src.nbytes / plain.ms / 1e6:6.1f} GB/s; "
              f"host a launch {kernel.host_ms:.4f} and {plain.host_ms:.4f} ms)", flush=True)


if __name__ == "__main__":
    main()
