"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

The port runs the unified paged serve path of the dense decoder on an
NVIDIA H100, with hand-written CUDA paged-decode and paged-span attention
kernels.  It imports torch and never jax, and nothing from ``repro``: the
JAX package is the reference its tests hold it against.
"""
