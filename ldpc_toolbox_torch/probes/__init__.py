"""Probes of the card's own ceilings at the decode kernels' shapes.

Each module ports one of the JAX package's TPU probes under
``tools/prof_*.py`` and bears its name: ``copybw`` (P1, a copy stream of
slabs), ``vpu_peak`` (P2, chained elementwise rounds), ``roll`` (P3, a
rotated gather), ``v2`` (P4, a copy and min-sum with scattered writes) and
``layered_variants`` (P5, the layered sweep with parts removed). Each has
its kernel's wrapper (CUDA kernels of ``csrc/probes.cu`` and
``csrc/probe_layered.cu``), the plain PyTorch version, and a ``main`` that
prints the tool's lines at the tool's shapes on the card::

    python -m ldpc_toolbox_torch.probes.copybw
"""
