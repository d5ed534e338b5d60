"""Masked cosine and euclidean k-means over a padded feature set (PyTorch
port of `gcdlss_tpu/algo/kmeans.py`).

Replaces `fast_pytorch_kmeans.KMeans(mode='cosine')` of the reference's
Stage-2 over-clustering. Every Lloyd iteration is one [N, C] x [C, K] product
and a masked one-hot segment mean; invalid rows are excluded by the mask.
Fixed shapes and a fixed iteration count, so nothing waits for the host.
"""

from __future__ import annotations

import torch


def _normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


def _select_init(x: torch.Tensor, valid: torch.Tensor, k: int,
                 scores: torch.Tensor) -> torch.Tensor:
    """The k rows with the smallest `scores + (~valid) * 1e6`, smallest
    first, ties to the lower index (the JAX package's `lax.top_k` of the
    negated scores)."""
    s = scores + (~valid).to(scores.dtype) * 1e6
    idx = torch.sort(s, stable=True).indices[:k]
    return x[idx]


def _kmeans(feats, valid, k: int, scores, iters: int, cosine: bool):
    x = _normalize(feats) if cosine else feats
    x = x * valid[:, None].to(x.dtype)
    cents = _select_init(x, valid, k, scores)
    vmask = valid[:, None].to(x.dtype)

    def sim(cents):
        if cosine:
            return x @ _normalize(cents).T
        return 2 * (x @ cents.T) - (cents * cents).sum(dim=-1)[None, :]

    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(sim(cents).argmax(dim=-1), k).to(x.dtype) * vmask
        sums = onehot.T @ x
        counts = onehot.sum(dim=0)[:, None]
        cents = torch.where(counts > 0, sums / counts.clamp(min=1.0), cents)
    return torch.where(valid, sim(cents).argmax(dim=-1), -1).to(torch.int32), cents


def cosine_kmeans(feats: torch.Tensor, valid: torch.Tensor, k: int, scores: torch.Tensor,
                  iters: int = 20):
    """Returns (assignments [N] int32, -1 for invalid rows; centroids [K, C]).

    `scores` [N] is a uniform [0, 1) draw that picks the k initial centroids
    among the valid rows. Centroids are means of the normalized member
    vectors (fast_pytorch_kmeans' cosine mode); a cluster left empty keeps
    its centroid."""
    return _kmeans(feats, valid, k, scores, iters, True)


def euclidean_kmeans(feats: torch.Tensor, valid: torch.Tensor, k: int, scores: torch.Tensor,
                     iters: int = 20):
    """`cosine_kmeans` on the raw rows with the squared euclidean distance
    (assignments by the largest 2 <x, c> - |c|^2)."""
    return _kmeans(feats, valid, k, scores, iters, False)
