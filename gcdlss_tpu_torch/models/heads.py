"""Auxiliary heads: prototypes, cosine prototypes, projection MLP, multi-head,
equiangular prototypes (PyTorch).

Port of `gcdlss_tpu/models/heads.py` (reference `models/multiheadminkunet.py:9-119`
and `models/multiheadminkunet_nops.py:8-43`). The heads act on dense
`[N, C]` feature rows, so they compose with any backbone output. Submodules
and parameters carry the flax names (`prototypes.kernel`, `weight`,
`fc{i}`, `head{h}`, `embedding`), so a JAX tree maps on path by path
(`utils.weights.library_jax_to_state_dict`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import Linear


def _normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=1e-12)


class Prototypes(nn.Module):
    """Linear prototype head (a 1x1 conv without bias): `prototypes.kernel`
    [C, P]."""

    def __init__(self, in_channels: int, num_prototypes: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.prototypes = Linear(in_channels, num_prototypes, bias=False, generator=generator)

    def forward(self, x):
        return self.prototypes(x)


class CosinePrototypes(nn.Module):
    """`scale * cos(x, w)`: rows of x and of `weight` [P, C] normalised,
    norms floored at 1e-12; `weight` drawn uniform(-1, 1)."""

    def __init__(self, in_channels: int, num_prototypes: int, scale: float = 10.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.scale = scale
        self.weight = nn.Parameter(torch.empty(num_prototypes, in_channels).uniform_(
            -1.0, 1.0, generator=generator))

    def forward(self, x):
        return self.scale * (_normalize(x) @ _normalize(self.weight).T)


class ProjectionHead(nn.Module):
    """MLP `in -> 128 -> 256 -> 256` with ReLU between the layers, xavier-
    uniform kernels and zero biases (`fc0`, `fc1`, `fc2`)."""

    def __init__(self, in_channels: int, dims: tuple = (128, 256, 256),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.depth = len(dims)
        c = in_channels
        for i, d in enumerate(dims):
            fc = Linear(c, d, generator=generator)
            nn.init.xavier_uniform_(fc.kernel, generator=generator)
            self.add_module(f"fc{i}", fc)
            c = d

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"fc{i}")(x)
            if i + 1 < self.depth:
                x = torch.relu(x)
        return x


class MultiHead(nn.Module):
    """`num_heads` independent prototype heads `head{h}` (cosine ones if
    asked); returns the stacked logits [H, N, P]."""

    def __init__(self, in_channels: int, num_prototypes: int, num_heads: int,
                 cosine: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.num_heads = num_heads
        cls = CosinePrototypes if cosine else Prototypes
        for h in range(num_heads):
            self.add_module(f"head{h}", cls(in_channels, num_prototypes, generator=generator))

    def forward(self, x):
        return torch.stack([getattr(self, f"head{h}")(x) for h in range(self.num_heads)])


def _equiangular_matrix(feat_in: int, num_prototypes: int, seed: int = 0) -> np.ndarray:
    """Fixed simplex-equiangular prototype matrix via QR orthogonalization
    (the JAX package's numpy construction, so both build the same bits)."""
    rng = np.random.default_rng(seed)
    a = rng.random((feat_in, num_prototypes))
    p, _ = np.linalg.qr(a)
    i = np.eye(num_prototypes)
    one = np.ones((num_prototypes, num_prototypes))
    m = np.sqrt(num_prototypes / (num_prototypes - 1)) * (
        p @ (i - one / num_prototypes)
    )
    return m.astype(np.float32)


class EquiangularPrototypes(nn.Module):
    """A learned bias-free `embedding` to C/2 with ReLU, then the cosine
    against the fixed equiangular matrix [C/2, P], which is normalised
    along axis 0 (its columns). The matrix is a buffer outside the state
    dict, as it is outside the flax parameters."""

    def __init__(self, in_channels: int, num_prototypes: int, seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        half = in_channels // 2
        self.embedding = Linear(in_channels, half, bias=False, generator=generator)
        self.register_buffer("matrix", torch.as_tensor(
            _equiangular_matrix(half, num_prototypes, seed)), persistent=False)

    def forward(self, x):
        h = torch.relu(self.embedding(x))
        return _normalize(h) @ _normalize(self.matrix, dim=0)
