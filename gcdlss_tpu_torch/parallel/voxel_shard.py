"""Voxel-sharded sparse convolution over a process group (PyTorch port of
`gcdlss_tpu/parallel/voxel_shard.py`).

Each level's rows split into contiguous blocks over the ranks of a ring
group, the port's counterpart of the JAX package's `sp` mesh axis. Levels
are sorted by packed (b, x, y, z) keys, so a block is a key range, a
spatial slab, and a k <= 5 kernel's neighbour rows lie in a thin band
around it: a rank exchanges `halo` boundary rows with its ring neighbours
and runs the same gather-GEMM kernels (K1 forward, K2 backward;
`ops.fused_conv`) on its window `[left halo | local block | right halo]`.

  * Books are built once per plan and rank (`subm_book`, `pool_book`):
    the plan's global row indices are remapped into the rank's window
    (`_window_remap`), and the adjoint book is written out beside the
    forward one. An entry that misses the window is dropped and counted
    (`overflow`), as in the JAX package; `required_halo_*` size the halo
    that drops none.
  * The exchange is differentiable: `halo_window` and `fold_halo` are one
    pair of autograd Functions, each the other's backward (JAX derives the
    pair from the transposes of `ppermute` and `psum`).
  * The exchange is an all-reduce of zero-padded per-rank slots, as
    `parallel.mesh` gathers: all-reduce is what NCCL, gloo on the CPU and
    gloo on CUDA tensors (two ranks sharing one card) all serve, where gloo
    moves CUDA tensors by no point-to-point call. It moves `world x 2h x C`
    values a conv where a ring's sends would move `2h x C`.

Wraparound: the left halo of rank 0 and the right halo of the last rank
hold another rank's rows (at world 2 both neighbours are the same rank).
No book entry points at them, so they are never gathered, and in a fold
they carry zeros only.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ops.conv import masked_batch_norm_stats
from ..ops.fused_conv import pool_conv
from .mesh import all_gather_padded, all_reduce, rank_of, world_size


def conv_axis(sp_axis):
    """The ring group voxel rows are sharded over. A pair `(group, ring)`
    is a composed dp x sp mesh: rows ride the ring; batch-norm moments,
    loss means and gradients reduce over `group`, every rank of the mesh
    (`stats_axis`)."""
    return sp_axis[-1] if isinstance(sp_axis, tuple) else sp_axis


def stats_axis(sp_axis):
    """The group batch statistics, loss means and gradients reduce over."""
    return sp_axis[0] if isinstance(sp_axis, tuple) else sp_axis


def _check_hops(halo: int, ln: int, world: int) -> int:
    """Ring hops a halo of `halo` rows needs with `ln` local rows; raises
    past (world - 1) // 2, where the window would wrap onto itself."""
    hops = -(-halo // ln)
    if hops > (world - 1) // 2 and halo > ln:
        raise ValueError(
            f"halo {halo} needs {hops} ring hops with local rows {ln}; at "
            f"most {(world - 1) // 2} available on a {world}-way mesh — raise the "
            "level capacity or use fewer shards")
    return hops


def padded_halo(halo: int, ln: int) -> int:
    """The effective window halo `halo_window` materializes: slab halos
    stay exact, multi-hop halos round up to whole blocks."""
    return halo if halo <= ln else -(-halo // ln) * ln


def _window(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    ln, w, r = x.shape[0], world_size(group), rank_of(group)
    if halo <= ln:
        slots = x.new_zeros((w, 2, halo, *x.shape[1:]))
        slots[r, 0] = x[ln - halo:]  # my tail: the right neighbour's left halo
        slots[r, 1] = x[:halo]  # my head: the left neighbour's right halo
        slots = all_reduce(slots, group)
        return torch.cat([slots[(r - 1) % w, 0], x, slots[(r + 1) % w, 1]])
    hops = _check_hops(halo, ln, w)
    blocks = all_gather_padded(x, group)
    return torch.cat([blocks[(r - k) % w] for k in range(hops, 0, -1)] + [x]
                     + [blocks[(r + k) % w] for k in range(1, hops + 1)])


def _fold(part: torch.Tensor, ln: int, halo: int, group) -> torch.Tensor:
    w, r = world_size(group), rank_of(group)
    out = part[halo:halo + ln].clone()
    if halo <= ln:
        # window rows [0, halo) are the left neighbour's tail, rows
        # [halo + ln, ...) the right neighbour's head
        slots = part.new_zeros((w, 2, halo, *part.shape[1:]))
        slots[r, 0] = part[:halo]
        slots[r, 1] = part[halo + ln:]
        slots = all_reduce(slots, group)
        out[ln - halo:] += slots[(r + 1) % w, 0]
        out[:halo] += slots[(r - 1) % w, 1]
        return out
    if halo % ln:
        raise ValueError("a multi-hop fold needs a block-padded halo")
    hops = halo // ln
    # window block hops - k covers rank r - k's rows, block hops + k rank r + k's
    buf = part.new_zeros((w, ln, *part.shape[1:]))
    for k in range(1, hops + 1):
        buf[(r - k) % w] += part[(hops - k) * ln:(hops - k + 1) * ln]
        buf[(r + k) % w] += part[(hops + k) * ln:(hops + k + 1) * ln]
    return out + all_reduce(buf, group)[r]


class _HaloWindow(torch.autograd.Function):
    """[L, ...] -> [L + 2 * padded halo, ...]; backward: `_FoldHalo`."""

    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.ln, ctx.halo, ctx.group = x.shape[0], padded_halo(halo, x.shape[0]), group
        return _window(x, halo, group)

    @staticmethod
    def backward(ctx, g):
        return _FoldHalo.apply(g.contiguous(), ctx.ln, ctx.halo, ctx.group), None, None


class _FoldHalo(torch.autograd.Function):
    """[L + 2 * halo, ...] partial sums -> [L, ...]; backward: `_HaloWindow`."""

    @staticmethod
    def forward(ctx, part, ln, halo, group):
        ctx.halo, ctx.group = halo, group
        return _fold(part, ln, halo, group)

    @staticmethod
    def backward(ctx, g):
        return _HaloWindow.apply(g.contiguous(), ctx.halo, ctx.group), None, None, None


def halo_window(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """[L, ...] local rows -> [L + 2 * padded_halo(halo, L), ...] with the
    ring neighbours' edge rows around them.

    halo <= L takes the neighbours' edge slabs; a larger halo (pool maps
    between levels whose fill fractions differ) takes whole blocks, up to
    (world - 1) // 2 of them each way, and raises beyond."""
    if halo == 0:
        return x
    _check_hops(halo, x.shape[0], world_size(group))
    return _HaloWindow.apply(x, halo, group)


def fold_halo(part: torch.Tensor, ln: int, halo: int, group) -> torch.Tensor:
    """Adjoint of `halo_window`: fold a [ln + 2 * halo, ...] window of
    partial sums onto the [ln] local block, each boundary slab or block
    added on its home rank. `halo` must be the padded (window) halo."""
    if halo == 0:
        return part
    return _FoldHalo.apply(part, ln, halo, group)


def _ring(group) -> tuple:
    return rank_of(group), world_size(group)


def _window_remap(idx: torch.Tensor, n_local: int, halo: int, group):
    """Global row indices -> window-relative; (-1, counted) when outside.

    `idx` may hold -1 (absent) or values >= the global capacity (pool
    sentinel); both are dropped silently — only in-range global rows that
    miss the window count as overflow. Returns (rows int32, overflow int32)."""
    i, d = _ring(group)
    base = i * n_local - halo
    rel = idx - base
    inside = (rel >= 0) & (rel < n_local + 2 * halo)
    in_range = (idx >= 0) & (idx < d * n_local)
    ok = in_range & inside
    overflow = (in_range & ~inside).sum().to(torch.int32)
    return torch.where(ok, rel, -1).to(torch.int32), overflow


def _window_rows(table: torch.Tensor, n_local: int, halo: int, group):
    """The rows of a global [cap, K] table at this rank's window rows (-1
    rows where a window row is no row of the level: the wrapped halos)."""
    i, _ = _ring(group)
    g = torch.arange(n_local + 2 * halo, device=table.device) + (i * n_local - halo)
    ok = (g >= 0) & (g < table.shape[0])
    rows = table[g.clamp(0, table.shape[0] - 1)]
    return torch.where(ok[:, None], rows, -1)


def _to_local(idx: torch.Tensor, n_local: int, group) -> torch.Tensor:
    """Global rows -> rows of this rank's block, -1 outside it."""
    i, _ = _ring(group)
    rel = idx - i * n_local
    return torch.where((idx >= 0) & (rel >= 0) & (rel < n_local), rel, -1).to(torch.int32)


class WindowBook(NamedTuple):
    """A submanifold conv's books on one rank: `nbr` [L, K] local output
    rows -> window rows, `adj` [L + 2 * halo, K] window rows -> local output
    rows (the adjoint), the padded `halo`, the entries `nbr` dropped
    (`overflow`, JAX's count) and the ring `group`."""

    nbr: torch.Tensor
    adj: torch.Tensor
    halo: int
    overflow: torch.Tensor
    group: Any


class WindowPool(NamedTuple):
    """A k=2 s=2 pool edge's books on one rank: `children` [Lc + 2 * halo,
    8] coarse window rows -> local fine rows and `upmap` [Lf, 8] local fine
    rows -> coarse window rows (the same (coarse, fine, offset) triples from
    either side), `lc` coarse rows a rank, the padded coarse `halo`, the
    fine rows whose parent misses the window (`overflow`, JAX's count) and
    the ring `group`."""

    children: torch.Tensor
    upmap: torch.Tensor
    lc: int
    halo: int
    overflow: torch.Tensor
    group: Any


def _block(cap: int, world: int, what: str) -> int:
    if cap % world:
        raise ValueError(f"{what} capacity {cap} does not divide by {world} shards")
    return cap // world


def subm_book(nbr: torch.Tensor, halo: int, group) -> WindowBook:
    """This rank's books of a global submanifold map `nbr` [cap, K].

    The adjoint is not the forward book read backwards, as on one device:
    its rows are the window's, its values local output rows. For a
    negation-symmetric map it is the column-reversed global map at the
    window rows, remapped into the local block."""
    i, d = _ring(group)
    ln = _block(nbr.shape[0], d, "level")
    _check_hops(halo, ln, d)
    h = padded_halo(halo, ln)
    fwd, overflow = _window_remap(nbr[i * ln:(i + 1) * ln], ln, h, group)
    adj = _to_local(_window_rows(nbr, ln, h, group).flip(1), ln, group)
    return WindowBook(fwd.contiguous(), adj.contiguous(), h, overflow, group)


def pool_book(pool, cap_coarse: int, halo: int, group) -> WindowPool:
    """This rank's books of a global pool edge (`ops.plan.PoolPlan`) into a
    coarse level of `cap_coarse` rows: the `children` of the coarse window
    rows remapped to local fine rows, the `upmap` of the local fine rows
    remapped to coarse window rows; the overflow is JAX's, of the local
    fine rows' `parent`."""
    i, d = _ring(group)
    lf = _block(pool.parent.shape[0], d, "fine level")
    lc = _block(cap_coarse, d, "coarse level")
    _check_hops(halo, lc, d)
    h = padded_halo(halo, lc)
    _, overflow = _window_remap(pool.parent[i * lf:(i + 1) * lf], lc, h, group)
    upmap, _ = _window_remap(pool.upmap[i * lf:(i + 1) * lf], lc, h, group)
    children = _to_local(_window_rows(pool.children, lc, h, group), lf, group)
    return WindowPool(children.contiguous(), upmap.contiguous(), lc, h, overflow, group)


def sp_gather_conv(x: torch.Tensor, book: WindowBook, w: torch.Tensor):
    """Submanifold sparse conv on a voxel-sharded level: [L, Ci] local rows
    (invalid rows 0) -> ([L, Co] in x's dtype, overflow). K1 over the
    window book, K2 over its adjoint; the window's cotangent goes home
    through `fold_halo`."""
    src = halo_window(x, book.halo, book.group)
    return pool_conv(src, book.nbr, book.adj, w), book.overflow


def sp_down_conv(x: torch.Tensor, pool: WindowPool, w: torch.Tensor):
    """Strided k2s2 down conv, fine block -> coarse block: f32 partial sums
    over the coarse window from the local fine rows (K1 over `children`),
    folded across the shard boundaries. Returns ([lc, Co] f32, overflow)."""
    part = pool_conv(x, pool.children, pool.upmap, w, f32_sums=True)
    return fold_halo(part, pool.lc, pool.halo, pool.group), pool.overflow


def sp_up_conv(x_coarse: torch.Tensor, pool: WindowPool, w: torch.Tensor):
    """Transpose k2s2 up conv: each local fine row gathers its parent from
    the coarse window (K1 over `upmap`). Returns ([Lf, Co], overflow)."""
    src = halo_window(x_coarse, pool.halo, pool.group)
    return pool_conv(src, pool.upmap, pool.children, w), pool.overflow


def sp_bn_stats(x: torch.Tensor, valid: torch.Tensor, group):
    """Batch statistics over the valid rows of every rank: (mean [C],
    biased var [C], count), f32. Two passes (the mean, then the centred
    squares; `ops.conv.masked_batch_norm_stats`), where the JAX package
    takes one (E[x^2] - E[x]^2): the second pass costs one more all-reduce
    of C values and keeps the variance of rows far from 0 from cancelling."""
    return masked_batch_norm_stats(x.float(), valid, group)


# ---------------------------------------------------------------------------
# halo sizing (outside any group)
# ---------------------------------------------------------------------------


def required_halo_subm(nbr: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Smallest halo for which a contiguous-block sharding of this
    neighbor map overflows nowhere. nbr: [cap, K] global indices."""
    cap = nbr.shape[0]
    ln = cap // n_shards
    start = (torch.arange(cap, dtype=torch.int32, device=nbr.device) // ln * ln)[:, None]
    v = nbr >= 0
    below = torch.where(v, start - nbr, 0)
    above = torch.where(v, nbr - (start + ln - 1), 0)
    return torch.maximum(below.max(), above.max()).to(torch.int32)


def required_halo_pool(parent: torch.Tensor, cap_coarse: int, n_shards: int) -> torch.Tensor:
    """Smallest coarse halo for the down/up k2s2 maps: fine shard i's
    parents must land in coarse window [i*lc - h, (i+1)*lc + h)."""
    capf = parent.shape[0]
    lf = capf // n_shards
    lc = cap_coarse // n_shards
    start = torch.arange(capf, dtype=torch.int32, device=parent.device) // lf * lc
    v = (parent >= 0) & (parent < cap_coarse)
    below = torch.where(v, start - parent, 0)
    above = torch.where(v, parent - (start + lc - 1), 0)
    return torch.maximum(below.max(), above.max()).to(torch.int32)


def required_halos(plan, n_shards: int) -> dict:
    """Per-level subm/pool halo requirements of a `UNetPlan` (int32
    scalars on the plan's device). Keys: 'stem', 'subm{l}', 'pool{l}'."""
    out = {"stem": required_halo_subm(plan.stem_nbr, n_shards)}
    for l, lvl in enumerate(plan.levels):
        out[f"subm{l}"] = required_halo_subm(lvl.nbr3, n_shards)
    for l, pool in enumerate(plan.pools):
        out[f"pool{l}"] = required_halo_pool(pool.parent, plan.levels[l + 1].valid.shape[0],
                                             n_shards)
    return out
