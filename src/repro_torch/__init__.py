"""PyTorch/CUDA port of the correlated-SH medoid system, for one NVIDIA H100.

The JAX package ``repro`` is the reference; module names here mirror it so a
reader finds each counterpart. The port imports neither ``jax`` nor
``repro``. Its entry points run on CUDA unless the caller passes
``device="cpu"``; the hot loop's kernels are hand-written CUDA C++ in
``kernels/csrc/``, built with ``nvcc`` at first use.
"""
