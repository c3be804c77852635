"""ldpc_toolbox_torch — the LDPC toolbox on PyTorch, with CUDA kernels for
NVIDIA Hopper.

The port of ``ldpc_toolbox_tpu``, module for module under the same names.
Plain tensor code is PyTorch; each kernel that the JAX package wrote in
Pallas for the TPU is a hand-written CUDA kernel under ``csrc/``, built with
nvcc at first use, and sits beside its plain PyTorch version. The JAX
package stays the reference: this package never imports jax, and shares
only the JAX package's numpy modules (``sparse``, ``gf2``, ``codes``,
``systematic``, ``utils``).
"""

__version__ = "0.1.0"
