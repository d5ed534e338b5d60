"""gcdlss_tpu_torch — the PyTorch/CUDA port of gcdlss_tpu for NVIDIA Hopper.

The JAX package `gcdlss_tpu` stays the reference. This package imports torch
and never jax; from the JAX package it reuses only the jax-free host data
pipeline (`gcdlss_tpu.data`) and the jax-free checkpoint-layout helpers of
`gcdlss_tpu.utils.import_torch`. Its sparse-conv and neighbor-map kernels are
CUDA C++ for sm_90a under `csrc/`, built at first use (`ops/_build.py`).
"""

__version__ = "0.1.0"
