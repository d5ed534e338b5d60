"""Plain PyTorch reference of the sparse UNet plan and its convolutions.

A level holds the voxels of one stride as sorted (b, x, y, z) keys, valid
rows only. A submanifold conv of kernel size k sums, for each output voxel
u and each offset d of the k^3 cube (product order, z fastest), x[v] @ W[d]
where v is the voxel at u + d. A k = 2, s = 2 pool edge maps each fine voxel
to its parent (coordinates halved, rounded down) with offset code
(x & 1) << 2 | (y & 1) << 1 | (z & 1): the down conv sums x[f] @ W[code] into
the parent, the up conv writes x_coarse[parent] @ W[code] onto each child.
A level keeps at most its capacity of voxels, the first in key order.

A conv is a list of (output rows, input rows) pairs per offset. Its autograd
Function keeps only its input and recomputes the gathers in the backward
pass. `quant`, when given, rounds the operands of every product (x and W
forward; the cotangent, x and W backward) as a lower-precision control.
"""

from __future__ import annotations

import itertools

import torch

_SHIFT = 1 << 16


def pack(coords: torch.Tensor) -> torch.Tensor:
    """(b, x, y, z) int rows -> int64 keys in lexicographic order."""
    c = coords.to(torch.int64)
    return (((c[:, 0] * _SHIFT + c[:, 1] + _SHIFT // 2) * _SHIFT + c[:, 2] + _SHIFT // 2)
            * _SHIFT + c[:, 3] + _SHIFT // 2)


def offsets(k: int) -> list:
    r = range(-(k // 2), k // 2 + 1)
    return list(itertools.product(r, r, r))


class Level:
    def __init__(self, coords: torch.Tensor, count: int):
        self.coords = coords  # [n, 4] int64, sorted by key
        self.keys = pack(coords)
        self.count = count  # unique voxels before the capacity
        self.n = coords.shape[0]


def cube_book(level: Level, k: int) -> list:
    """[(out rows, in rows)] per offset of the k^3 cube."""
    book = []
    rows = torch.arange(level.n, device=level.keys.device)
    for d in offsets(k):
        q = level.coords.clone()
        q[:, 1:] += torch.tensor(d, device=q.device)
        qk = pack(q)
        pos = torch.searchsorted(level.keys, qk).clamp(max=max(level.n - 1, 0))
        hit = level.keys[pos] == qk
        book.append((rows[hit], pos[hit]))
    return book


def pool(level: Level, cap: int):
    """(coarse level, parent of each fine row or -1, offset code of each)."""
    c = level.coords
    parent_coords = torch.cat([c[:, :1], torch.div(c[:, 1:], 2, rounding_mode="floor")], dim=1)
    code = ((c[:, 1] & 1) << 2) | ((c[:, 2] & 1) << 1) | (c[:, 3] & 1)
    keys, inverse = torch.unique(pack(parent_coords), sorted=True, return_inverse=True)
    count = keys.shape[0]
    first = torch.full((count,), c.shape[0], dtype=torch.int64, device=c.device)
    first.scatter_reduce_(0, inverse, torch.arange(c.shape[0], device=c.device), "amin")
    keep = min(count, cap)
    coarse = Level(parent_coords[first[:keep]], count)
    parent = torch.where(inverse < keep, inverse, -1)
    return coarse, parent, code


def pool_books(parent: torch.Tensor, code: torch.Tensor):
    """(down book: coarse <- fine, up book: fine <- coarse), per offset code."""
    rows = torch.arange(parent.shape[0], device=parent.device)
    down, up = [], []
    for d in range(8):
        m = (code == d) & (parent >= 0)
        down.append((parent[m], rows[m]))
        up.append((rows[m], parent[m]))
    return down, up


class Plan:
    """Levels 0..L-1 of one batch with their books: the stem's k^stem cube at
    level 0, a 3^3 cube at every level, and the pool edges' books."""

    def __init__(self, coords0: torch.Tensor, caps: tuple, stem_k: int = 5):
        keys = pack(coords0)
        if keys.shape[0] > 1 and not bool((keys[1:] > keys[:-1]).all()):
            raise ValueError("level-0 voxels must be unique and in key order")
        self.levels = [Level(coords0[:caps[0]], coords0.shape[0])]
        self.down, self.up = [], []
        for cap in caps[1:]:
            coarse, parent, code = pool(self.levels[-1], cap)
            down, up = pool_books(parent, code)
            self.down.append(down)
            self.up.append(up)
            self.levels.append(coarse)
        self.stem = cube_book(self.levels[0], stem_k)
        self.cube = [cube_book(lvl, 3) for lvl in self.levels]

    def overflow(self) -> int:
        return sum(lvl.count - lvl.n for lvl in self.levels)


def _same(x):
    return x


class PairConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, book, n_out, quant):
        q = quant or _same
        ctx.save_for_backward(x, w)
        ctx.book, ctx.quant = book, quant
        xq, wq = q(x), q(w)
        out = torch.zeros((n_out, w.shape[2]), dtype=x.dtype, device=x.device)
        for k, (o, i) in enumerate(book):
            if o.numel():
                out.index_add_(0, o, xq[i] @ wq[k])
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        q = ctx.quant or _same
        xq, wq, gq = q(x), q(w), q(g)
        gx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        gw = torch.zeros_like(w)
        for k, (o, i) in enumerate(ctx.book):
            if not o.numel():
                continue
            go = gq[o]
            if gx is not None:
                gx.index_add_(0, i, go @ wq[k].T)
            gw[k] = xq[i].T @ go
        return gx, gw, None, None, None


def conv(x: torch.Tensor, w: torch.Tensor, book: list, n_out: int, quant=None) -> torch.Tensor:
    return PairConv.apply(x, w, book, n_out, quant)


class QuantMatmul(torch.autograd.Function):
    """x @ w with every product's operands rounded by `quant`, forward and
    backward."""

    @staticmethod
    def forward(ctx, x, w, quant):
        ctx.save_for_backward(x, w)
        ctx.quant = quant
        return quant(x) @ quant(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        q = ctx.quant
        gq = q(g)
        return gq @ q(w).T, q(x).T @ gq, None
