"""ldpc_toolbox_torch — the LDPC toolbox on PyTorch, with CUDA kernels for
NVIDIA Hopper.

The port of ``ldpc_toolbox_tpu``, module for module under the same names.
Plain tensor code is PyTorch; each kernel that the JAX package wrote in
Pallas for the TPU is a hand-written CUDA kernel under ``csrc/``, built with
nvcc at first use, and sits beside its plain PyTorch version. The JAX
package stays the reference: this package never imports jax and imports
nothing of the JAX package. It keeps its own copies of the jax-free
modules it needs (``sparse``, ``gf2``, ``codes``, the lifted layout), which
``tests/test_torch_layout.py`` holds equal to the originals.
"""

__version__ = "0.1.0"
