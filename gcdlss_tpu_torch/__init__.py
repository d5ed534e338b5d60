"""gcdlss_tpu_torch — the PyTorch/CUDA port of gcdlss_tpu for NVIDIA Hopper.

The JAX package `gcdlss_tpu` stays the reference. This package imports torch,
never jax, and nothing of the JAX package: it keeps its own copies of the
host data pipeline (`data/`, numpy) and of the checkpoint-layout helpers
(`utils/weights.py`). Its sparse-conv, neighbor-map and conv-component kernels
are CUDA C++ for sm_90a under `csrc/`, built at first use (`ops/_build.py`).
"""

__version__ = "0.1.0"
