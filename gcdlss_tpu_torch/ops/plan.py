"""UNet sparse-convolution plan: per-level coordinates and kernel maps.

Port of `gcdlss_tpu/ops/plan.py`. The whole network's rulebooks are built once
per batch from the stride-1 voxel coordinates; forward and backward reuse
them. Topology (MinkUNet, reference `models/minkunet.py:59-132`):

  * level 0 (stride 1): the k=5 stem map (125 offsets); its 27 k=3 columns
    are sliced out of it for the level-0 residual blocks;
  * levels 1..4 (strides 2, 4, 8, 16): k=3 maps (27 offsets);
  * four k=2 s=2 pool edges, each with `parent`/`dcode` and the explicit
    `children` (down) and `upmap` (up) books the pool convolutions gather by.

k^3 maps go through one of two kernels, chosen by the `plan_kernel` argument
(the JAX package's `GCDLSS_PLAN_KERNEL` modes 2 and 1):

  * 2 (default): `plan_kernel.cube_neighbor_map` (K3), which takes the keys
    as they are and writes every row whole in one launch (one search per
    (row, (dx, dy) column)); its plain version is `join_neighbor_map` below;
  * 1: `_column_ranks` (one insertion rank per row and non-center (dx, dy)
    column) feeding `plan_kernel.cube_candidates_map` (K4), which reads the
    <= k consecutive candidate rows at each rank.

Each wrapper takes its plain version for a tensor on the CPU and launches
its CUDA kernel for a tensor on the card. Neither kernel has a window, so
unlike the TPU path there is no overflow fallback and no far-pair repair.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from .coords import (FIELD, SENTINEL_HI, SENTINEL_LO, decode_keys, encode_coords,
                     sorted_unique, sorted_unique_nodup, sorted_unique_presorted)
from .join import sorted_join, sorted_rank_match
from .plan_kernel import cube_candidates_map, cube_neighbor_map

PLAN_KERNELS = (1, 2)  # K4 (ranks, then candidates), K3 (the search inside the kernel)


def _offsets(k: int) -> np.ndarray:
    r = range(-(k // 2), k // 2 + 1)
    return np.array(list(itertools.product(r, r, r)), dtype=np.int32)


class LevelPlan(NamedTuple):
    coords: torch.Tensor  # [cap, 4] int32 (b, x, y, z) in stride units
    valid: torch.Tensor  # [cap] bool
    count: torch.Tensor  # int32 scalar: true unique count before the cap
    nbr3: torch.Tensor  # [cap, 27] int32 k=3 neighbor rows (-1 absent)
    key_hi: torch.Tensor  # [cap] sorted packed keys
    key_lo: torch.Tensor


class PoolPlan(NamedTuple):
    parent: torch.Tensor  # [cap_fine] int32 coarse row (cap_coarse if none)
    dcode: torch.Tensor  # [cap_fine] int32 in [0, 8): k=2 offset code
    children: torch.Tensor  # [cap_coarse, 8] fine row per (parent, d), -1 absent
    upmap: torch.Tensor  # [cap_fine, 8] parent row at slot d == dcode, else -1


class UNetPlan(NamedTuple):
    levels: tuple  # LevelPlan per stride 1, 2, 4, 8, 16
    pools: tuple  # PoolPlan per edge level l -> l + 1
    stem_nbr: torch.Tensor  # [cap0, 125] k=5 map at level 0
    rep: torch.Tensor  # [cap0] level-0 row -> first input row (n_in for padding)
    inverse: torch.Tensor  # [n_in] input row -> level-0 row (cap0 if dropped)


def _join_offsets(coords, valid, key_hi, key_lo, offsets: np.ndarray) -> torch.Tensor:
    """[cap, len(offsets)] rows of coords + offset, by one sorted join."""
    cap = coords.shape[0]
    k = len(offsets)
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=coords.device)
    q = coords[:, None, 1:4] + offs[None, :, :]
    b = coords[:, None, 0:1].expand(cap, k, 1)
    qc = torch.cat([b, q], dim=2).reshape(-1, 4)
    qv = valid[:, None].expand(cap, k).reshape(-1)
    qh, ql = encode_coords(qc, qv)
    return sorted_join(key_hi, key_lo, qh, ql).reshape(cap, k)


def _transpose_half(half_nbr: torch.Tensor) -> torch.Tensor:
    """Adjoint columns: trans[j, half-1-k] = i wherever half_nbr[i, k] = j.

    Entries are unique except where encode_coords' clip folds two queries
    onto one voxel at the field's edge; there the largest row wins."""
    cap, half = half_nbr.shape
    dev = half_nbr.device
    rows = torch.arange(cap, dtype=torch.int32, device=dev)[:, None].expand(cap, half)
    tcol = (half - 1) - torch.arange(half, device=dev)[None, :]
    hit = half_nbr >= 0
    pos = half_nbr.long() * half + tcol
    out = torch.full((cap * half,), -1, dtype=torch.int32, device=dev)
    out.scatter_reduce_(0, pos[hit], rows[hit], reduce="amax")
    return out.reshape(cap, half)


def join_neighbor_map(key_hi: torch.Tensor, key_lo: torch.Tensor, k1: int) -> torch.Tensor:
    """[cap, k1^3] neighbor map of a sorted unique key level by sorted joins
    (the plain version of the k^3 map kernel): the first half of the offsets
    is joined, the center column is the row itself, the second half is the
    transpose of the first (offsets are negation-symmetric)."""
    cap = key_hi.shape[0]
    valid = key_hi != SENTINEL_HI
    coords = torch.where(valid[:, None], decode_keys(key_hi, key_lo), 0)
    offsets = _offsets(k1)
    half = len(offsets) // 2
    half_nbr = _join_offsets(coords, valid, key_hi, key_lo, offsets[:half])
    rows = torch.arange(cap, dtype=torch.int32, device=key_hi.device)
    center = torch.where(valid, rows, -1).to(torch.int32)
    return torch.cat([half_nbr, center[:, None], _transpose_half(half_nbr)], dim=1)


def _column_ranks(valid, key_hi, key_lo, k1: int):
    """(p, has) [k1^2 - 1, cap] for every non-center (dx, dy) column in
    product order: the insertion rank of each row's query key and whether its
    candidate run is non-empty (`join.sorted_rank_match`).

    Query keys are built arithmetically, hi + dx and lo + dy * FIELD - r (the
    window's lowest z), without `encode_coords`' clip, as the JAX package
    builds them; invalid rows query the sentinel. The column offsets are
    made on the device: a host copy would wait for the stream."""
    r = k1 // 2
    col = torch.arange(k1 * k1 - 1, dtype=torch.int32, device=key_hi.device)
    col = col + (col >= k1 * k1 // 2).to(torch.int32)  # skip the center column
    dhi = (col // k1 - r)[:, None]
    dlo = ((col % k1 - r) * FIELD - r)[:, None]
    qh = torch.where(valid[None, :], key_hi[None, :] + dhi, SENTINEL_HI)
    ql = torch.where(valid[None, :], key_lo[None, :] + dlo, SENTINEL_LO)
    p, has = sorted_rank_match(key_hi, key_lo, qh.reshape(-1), ql.reshape(-1), 2 * r)
    return p.reshape(qh.shape), has.reshape(qh.shape)


def neighbor_map(key_hi: torch.Tensor, key_lo: torch.Tensor, k1: int,
                 plan_kernel: int = 2) -> torch.Tensor:
    """[cap, k1^3] neighbor map of one level through K3 (`plan_kernel=2`) or
    K4 (`plan_kernel=1`)."""
    if plan_kernel == 2:
        return cube_neighbor_map(key_hi, key_lo, k1)
    if plan_kernel == 1:
        p, has = _column_ranks(key_hi != SENTINEL_HI, key_hi, key_lo, k1)
        return cube_candidates_map(key_hi, key_lo, p, has, k1)
    raise ValueError(f"plan_kernel must be one of {PLAN_KERNELS}, got {plan_kernel!r}")


def plan_capacity_overflow(plan: UNetPlan) -> torch.Tensor:
    """Total unique voxels dropped by the per-level capacities (int32)."""
    tot = torch.zeros((), dtype=torch.int32, device=plan.rep.device)
    for lvl in plan.levels:
        kept = lvl.valid.sum().to(torch.int32)
        tot = tot + (lvl.count - kept).clamp(min=0)
    return tot


def build_unet_plan(coords: torch.Tensor, valid: torch.Tensor, caps: tuple,
                    presorted: bool = False, assume_unique: bool = False,
                    plan_kernel: int = 2) -> UNetPlan:
    """Build the full per-batch plan from stride-1 voxel coords.

    Args:
      coords: [n_in, 4] int32 (b, x, y, z) stride-1 voxel coords (duplicates
        are merged; invalid rows masked by `valid`).
      valid: [n_in] bool.
      caps: per-level capacities, one per stride level (5 for MinkUNet).
      presorted: the valid rows of `coords` are already (b, x, y, z)-sorted
        (true for the host quantizer's output and its batch concatenation):
        skips the level-0 sort. Pool levels always sort.
      assume_unique: the caller promises no duplicate (b, x, y, z) rows (the
        voxel-level LaserMix re-batch); with caps[0] == n_in the level-0
        dedup bookkeeping is skipped (`coords.sorted_unique_nodup`).
      plan_kernel: 2 builds the k^3 maps with K3, 1 with K4 (`neighbor_map`).
    """
    hi, lo = encode_coords(coords, valid)
    if presorted:
        uniq0 = sorted_unique_presorted
    elif assume_unique and caps[0] == coords.shape[0]:
        uniq0 = sorted_unique_nodup
    else:
        uniq0 = sorted_unique
    (kh, kl), rep, inverse, count = uniq0(hi, lo, caps[0])
    dev = coords.device

    levels, pools = [], []
    stem_nbr = None
    for lev, cap in enumerate(caps):
        lvalid = kh != SENTINEL_HI
        lcoords = torch.where(lvalid[:, None], decode_keys(kh, kl), 0)
        if lev == 0:
            stem_nbr = neighbor_map(kh, kl, 5, plan_kernel)
            # the 27 k = 3 offsets are the inner 3^3 cube of the 125 (z fastest)
            nbr3 = stem_nbr.view(cap, 5, 5, 5)[:, 1:4, 1:4, 1:4].reshape(cap, 27)
        else:
            nbr3 = neighbor_map(kh, kl, 3, plan_kernel)
        levels.append(LevelPlan(lcoords, lvalid, count, nbr3, kh, kl))
        if lev + 1 == len(caps):
            break
        # pool to the next level: parent = c >> 1 (stride units), dcode = c & 1
        pcoord = torch.cat([lcoords[:, 0:1], lcoords[:, 1:4] >> 1], dim=1)
        dbits = lcoords[:, 1:4] & 1
        dcode = ((dbits[:, 0] << 2) | (dbits[:, 1] << 1) | dbits[:, 2]).to(torch.int32)
        ph, pl = encode_coords(pcoord, lvalid)
        (nh, nl), _, pinv, ncount = sorted_unique(ph, pl, caps[lev + 1])
        capc = caps[lev + 1]
        pok = lvalid & (pinv < capc)
        rows_f = torch.arange(cap, dtype=torch.int32, device=dev)
        # rows without a parent write one slot past the end, which is dropped
        children = torch.full((capc * 8 + 1,), -1, dtype=torch.int32, device=dev)
        children[torch.where(pok, pinv.long() * 8 + dcode, capc * 8)] = rows_f
        children = children[:capc * 8]
        slot = torch.arange(8, dtype=torch.int32, device=dev)[None, :]
        upmap = torch.where(pok[:, None] & (dcode[:, None] == slot), pinv[:, None], -1)
        pools.append(PoolPlan(pinv, dcode, children.reshape(capc, 8),
                              upmap.to(torch.int32)))
        kh, kl, count = nh, nl, ncount

    return UNetPlan(tuple(levels), tuple(pools), stem_nbr, rep, inverse)
