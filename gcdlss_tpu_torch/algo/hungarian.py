"""Hungarian assignment for tiny matrices, on the device (PyTorch port of
`gcdlss_tpu/algo/hungarian_jax.py`).

The Stage-2 step matches novel-head predictions to k-means cluster labels
every step: a Ku x Ku problem with Ku <= 6. All Ku! permutations are scored
at once and the first best one (in `itertools.permutations` order) wins, so
the step never copies the cost matrix to the host.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch


@functools.cache
def _perms(k: int) -> np.ndarray:
    return np.array(list(itertools.permutations(range(k))), np.int64)


def hungarian_small(cost: torch.Tensor, maximize: bool = True) -> torch.Tensor:
    """Optimal assignment for a [K, K] cost (K <= 6).

    Returns row_of_col [K] int64: column j is assigned row row_of_col[j], the
    permutation maximizing (or minimizing) sum_j cost[row_of_col[j], j]."""
    k = cost.shape[0]
    if k > 6:
        raise ValueError(f"hungarian_small enumerates permutations: K = {k} > 6")
    perms = torch.as_tensor(_perms(k), device=cost.device)
    cols = torch.arange(k, device=cost.device)
    scores = cost[perms, cols[None, :]].sum(dim=1)
    best = scores.argmax() if maximize else scores.argmin()
    return perms[best]
