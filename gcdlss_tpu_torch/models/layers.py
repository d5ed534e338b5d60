"""Sparse layers on padded `[N, C]` voxel rows (PyTorch).

Port of `gcdlss_tpu/models/layers.py`. Every layer takes explicit plan books
(`ops.plan`) and a validity mask; invalid rows stay zero. Every sparse conv,
the pool convs included, goes through the gather-GEMM kernels
(`ops.fused_conv`) on the card and their plain versions on the CPU.
Parameter names follow the reference checkpoint (`kernel` for convs,
`weight`/`bias`/`running_mean`/`running_var` for batch norms).

Given a rank's voxel-sharded plan (`parallel.sp_step.shard_plan`: window
books in place of the plan's books), the convs take the sharded route of
`parallel.voxel_shard`, still on K1/K2, and batch norm takes its statistics
over the ring's rows when the step sets `batch_norm_group`, as the JAX
package's layers do when given `sp_axis`.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from ..ops.fused_conv import pool_conv, subm_conv
from ..ops.fused_norm import sparse_batch_norm
from ..parallel.voxel_shard import (WindowBook, WindowPool, sp_down_conv, sp_gather_conv,
                                    sp_up_conv)


def mask_rows(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return x * valid[:, None].to(x.dtype)


def kaiming_conv_(w: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """He-normal for sparse conv kernels [K, Ci, Co] with fan_out = K * Co
    (`ME.utils.kaiming_normal_(mode="fan_out", nonlinearity="relu")`)."""
    k, _, co = w.shape
    with torch.no_grad():
        return w.normal_(0.0, math.sqrt(2.0 / (k * co)), generator=generator)


class SparseConv(nn.Module):
    """Submanifold sparse convolution over a k^3 neighbor book."""

    def __init__(self, in_channels: int, out_channels: int, kernel_volume: int = 27,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(kaiming_conv_(
            torch.empty(kernel_volume, in_channels, out_channels), generator))

    def forward(self, x, nbr, valid):
        if isinstance(nbr, WindowBook):
            return mask_rows(sp_gather_conv(x, nbr, self.kernel)[0], valid)
        return mask_rows(subm_conv(x, nbr, self.kernel), valid)


class SparseDownConv(nn.Module):
    """Strided k=2 s=2 conv onto the next coarser level (`children` book)."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(kaiming_conv_(
            torch.empty(8, in_channels, out_channels), generator))

    def forward(self, x, pool, out_valid):
        if isinstance(pool, WindowPool):
            return mask_rows(sp_down_conv(x, pool, self.kernel)[0].to(x.dtype), out_valid)
        return mask_rows(pool_conv(x, pool.children, pool.upmap, self.kernel), out_valid)


class SparseUpConv(nn.Module):
    """Transpose k=2 s=2 conv back onto the finer level (`upmap` book)."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(kaiming_conv_(
            torch.empty(8, in_channels, out_channels), generator))

    def forward(self, x_coarse, pool, out_valid):
        if isinstance(pool, WindowPool):
            return mask_rows(sp_up_conv(x_coarse, pool, self.kernel)[0], out_valid)
        return mask_rows(pool_conv(x_coarse, pool.upmap, pool.children, self.kernel),
                         out_valid)


_FROZEN_STATS = 0  # > 0: batch norm leaves its running statistics as they are


@contextlib.contextmanager
def frozen_batch_norm_stats():
    """Inside, a train-mode `SparseBatchNorm` normalizes with the batch's
    statistics but does not update its running ones: the recompute of a
    checkpointed block (`models.minkunet.ResLayer`, `remat`) must not count
    the batch twice. A process-wide count, not a thread's: the backward pass
    that recomputes may run on another thread than the forward."""
    global _FROZEN_STATS
    _FROZEN_STATS += 1
    try:
        yield
    finally:
        _FROZEN_STATS -= 1


_STATS_GROUP = None  # a process group: batch statistics over every rank's rows


@contextlib.contextmanager
def batch_norm_group(group):
    """Inside, a train-mode `SparseBatchNorm` takes its statistics over the
    valid rows of every rank of `group` (`ops.conv.masked_batch_norm_stats`);
    `None` leaves them the rank's own. Keep the backward pass inside too: a
    `remat` recompute takes the statistics again."""
    global _STATS_GROUP
    prev, _STATS_GROUP = _STATS_GROUP, group
    try:
        yield
    finally:
        _STATS_GROUP = prev


class SparseBatchNorm(nn.Module):
    """Batch norm over valid voxels (torch semantics: momentum 0.1, eps 1e-5).

    Normalizes with the biased batch variance; `running_var` stores the
    unbiased estimate, as `torch.nn.BatchNorm1d` inside `MinkowskiBatchNorm`.
    Statistics and the affine map are f32; the output has x's dtype. A
    caller may fold in the residual add and the ReLU that follow the norm."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, valid, residual=None, act: str = "none"):
        """`act(norm(x) + residual)` on the valid rows, zero elsewhere
        (`ops.fused_norm.sparse_batch_norm`: the kernels on the card)."""
        return sparse_batch_norm(x, valid, self.weight, self.bias, self.running_mean,
                                 self.running_var, self.training, self.momentum, self.eps,
                                 residual, act, _STATS_GROUP, not _FROZEN_STATS)


class Linear(nn.Module):
    """1x1 conv / dense layer with the reference's `kernel [Ci, Co]` layout.

    Computes in `dtype` (the activation dtype inside the backbone, f32 for
    heads); a plain matrix product, as the JAX package leaves it to XLA."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        # lecun-normal, the flax Dense default
        self.kernel = nn.Parameter(torch.empty(in_channels, out_channels).normal_(
            0.0, 1.0 / math.sqrt(in_channels), generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def normed_linear(x: torch.Tensor, w: torch.Tensor, scale: float = 10.0) -> torch.Tensor:
    """`scale * normalize(x, -1) @ normalize(w, 0)`, norms floored at 1e-12."""
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)
    wn = w / torch.linalg.vector_norm(w, dim=0, keepdim=True).clamp(min=1e-12)
    return scale * (xn @ wn)


class NormedLinear(nn.Module):
    """Cosine classifier (reference `models/minkunet.py:34-42`): rows and
    prototype columns normalised, product scaled by 10, in f32. `weight` is
    `[Ci, features]`, drawn uniform(-1, 1)."""

    def __init__(self, in_channels: int, out_channels: int, scale: float = 10.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.scale = scale
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels).uniform_(
            -1.0, 1.0, generator=generator))

    def forward(self, x):
        return normed_linear(x, self.weight, self.scale)
