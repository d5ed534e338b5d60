"""k^3 neighbor-map kernel wrappers (CUDA, `csrc/cube_map.cu`, `csrc/cube_cand.cu`).

K3 `cube_neighbor_map` replaces the TPU kernel `_kernel_v2` and K4
`cube_candidates_map` replaces the TPU kernel `_kernel` (v1), both of
`gcdlss_tpu/ops/plan_kernel.py`. K3's plain version is the join path,
`plan.join_neighbor_map`, which it equals bit for bit; K4's is
`cube_candidates_plain` below. Each wrapper takes its plain version only for
tensors on the CPU; for a CUDA tensor it launches its kernel or raises.

K3 computes every row of the map whole, in one launch, by the rule that
`cube_direct_rule` states in PyTorch: one search per (row, (dx, dy) column)
inside a rank range found once per block of rows, then the k1 table rows that
follow the rank.
"""

from __future__ import annotations

import itertools

import torch

from . import _build
from .coords import FIELD, SENTINEL_HI, pack_keys

CUBE_MAP_MAX_K1 = 21  # K3 serves odd k1 from 3 to this (its shared memory holds no more)


def cube_neighbor_map(key_hi: torch.Tensor, key_lo: torch.Tensor, k1: int) -> torch.Tensor:
    """[cap, k1^3] int32 neighbor rows (-1 absent) of one level's sorted,
    unique, sentinel-padded int32 keys; offsets in `plan._offsets(k1)` order.
    On the card: odd k1 from 3 to `CUBE_MAP_MAX_K1`, contiguous keys."""
    if key_hi.device.type == "cpu":
        from .plan import join_neighbor_map

        return join_neighbor_map(key_hi, key_lo, k1)
    if key_hi.device.type != "cuda":
        raise ValueError(f"cube_neighbor_map: unsupported device {key_hi.device}")
    if key_lo.device != key_hi.device:
        raise ValueError(f"cube_neighbor_map: key_lo is on {key_lo.device}")
    if key_hi.dtype != torch.int32 or key_lo.dtype != torch.int32:
        raise TypeError("cube_neighbor_map: keys must be int32")
    if key_hi.shape != key_lo.shape or key_hi.dim() != 1:
        raise ValueError("cube_neighbor_map: keys must be two [cap] vectors")
    if not (key_hi.is_contiguous() and key_lo.is_contiguous()):
        raise ValueError("cube_neighbor_map: keys must be contiguous")
    if k1 % 2 != 1 or not 3 <= k1 <= CUBE_MAP_MAX_K1:
        raise ValueError(f"cube_neighbor_map: the kernel serves odd k1 from 3 to "
                         f"{CUBE_MAP_MAX_K1}, got {k1}")
    cap = key_hi.shape[0]
    nbr = torch.empty((cap, k1 ** 3), dtype=torch.int32, device=key_hi.device)
    stream = torch.cuda.current_stream(key_hi.device).cuda_stream
    _build.check(_build.library().gcd_cube_map(key_hi.data_ptr(), key_lo.data_ptr(),
                                               nbr.data_ptr(), cap, k1, stream),
                 "cube_neighbor_map")
    cube_neighbor_map.launches += 1
    return nbr


cube_neighbor_map.launches = 0


def cube_direct_rule(key_hi: torch.Tensor, key_lo: torch.Tensor, k1: int) -> torch.Tensor:
    """The rule K3 computes each row by, in plain PyTorch: the join map read
    per row, without a transpose. With r = k1 // 2 and the coordinates offset
    into [0, FIELD):

      * a row whose x, y, z all lie in [r, FIELD - 1 - r] has, at every
        offset c of both halves, the row of the key `key + offset_c` (plain
        arithmetic on the packed key; nothing clips, and the only row whose
        query at the mirrored offset lands here is that neighbour);
      * a row within r of a face of the field has, at c < half, the row of
        the clipped query; at the center, itself; at c > half, the largest
        row among the voxels v with clip(v + offset_{kk-1-c}) = its own
        coordinates (the scatter-max of the join path's transpose).

    Equal to `plan.join_neighbor_map` on every sorted, unique,
    sentinel-padded level; the tests hold it to that."""
    cap = key_hi.shape[0]
    r = k1 // 2
    rng = range(-r, r + 1)
    offsets = list(itertools.product(rng, rng, rng))
    half = len(offsets) // 2
    keys = pack_keys(key_hi, key_lo)
    valid = key_hi != SENTINEL_HI
    x, y, z = key_hi % FIELD, key_lo // FIELD, key_lo % FIELD
    lo_c = torch.minimum(x, torch.minimum(y, z))
    hi_c = torch.maximum(x, torch.maximum(y, z))
    fast = valid & (lo_c >= r) & (hi_c <= FIELD - 1 - r)
    out = torch.full((cap, len(offsets)), -1, dtype=torch.int32, device=key_hi.device)

    def find(q: torch.Tensor) -> torch.Tensor:
        pos = torch.searchsorted(keys, q)
        safe = pos.clamp(max=cap - 1)
        return torch.where(keys[safe] == q, pos, -1).to(torch.int32)

    for c, (dx, dy, dz) in enumerate(offsets):
        out[:, c] = torch.where(fast, find(keys + ((dx << 32) + dy * FIELD + dz)), -1)

    table = {k: i for i, (k, ok) in enumerate(zip(keys.tolist(), valid.tolist())) if ok}

    def clip(v: int) -> int:
        return min(max(v, 0), FIELD - 1)

    def preimages(a: int, d: int) -> list:
        return [v for v in range(max(0, a - r), min(FIELD - 1, a + r) + 1) if clip(v + d) == a]

    for i in torch.nonzero(valid & ~fast).flatten().tolist():
        base = int(key_hi[i]) - int(x[i])  # b * FIELD
        xi, yi, zi = int(x[i]), int(y[i]), int(z[i])
        for c, (dx, dy, dz) in enumerate(offsets):
            if c == half:
                out[i, c] = i
            elif c < half:
                q = ((base + clip(xi + dx)) << 32) | (clip(yi + dy) * FIELD + clip(zi + dz))
                out[i, c] = table.get(q, -1)
            else:  # the rows whose query at the mirrored offset (-dx, -dy, -dz) lands here
                out[i, c] = max((table.get(((base + vx) << 32) | (vy * FIELD + vz), -1)
                                 for vx in preimages(xi, -dx) for vy in preimages(yi, -dy)
                                 for vz in preimages(zi, -dz)), default=-1)
    return out


def cube_candidates_plain(key_hi: torch.Tensor, key_lo: torch.Tensor, p: torch.Tensor,
                          has: torch.Tensor, k1: int) -> torch.Tensor:
    """Plain version of K4: the same candidate resolution as gathers and
    compares. Column c = (dx + r) * k1 + (dy + r) queries (hi + dx,
    lo + dy * FIELD - r) and reads table rows base + m, m < k1, inside
    [0, cap): base is p for the non-center columns (`p`/`has` rows in column
    order, center skipped) and i - r, clipped, for the center. A row whose hi
    equals the query's and whose lo - q_lo is in [0, 2r] fills slot
    c * k1 + (lo - q_lo). Invalid rows and queries with has = 0 stay -1."""
    cap = key_hi.shape[0]
    r = k1 // 2
    ncols = k1 * k1
    cc = ncols // 2
    dev = key_hi.device
    cols = torch.arange(ncols, dtype=torch.int32, device=dev)
    dhi = (cols // k1 - r)[:, None]
    dlo = ((cols % k1 - r) * FIELD - r)[:, None]
    rows = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = key_hi != SENTINEL_HI
    base = torch.cat([p[:cc], (rows - r).clamp(0, cap - 1)[None], p[cc:]])
    live = torch.cat([has[:cc], valid[None], has[cc:]]) & valid[None]
    qh = key_hi[None] + dhi
    ql = key_lo[None] + dlo
    out = torch.full((cap, ncols, k1), -1, dtype=torch.int32, device=dev)
    for m in range(k1):
        crow = base + m
        safe = crow.clamp(max=cap - 1).long()
        delta = key_lo[safe] - ql
        ok = live & (crow < cap) & (key_hi[safe] == qh) & (delta >= 0) & (delta <= 2 * r)
        c_idx, i_idx = ok.nonzero(as_tuple=True)
        out[i_idx, c_idx, delta[ok].long()] = crow[ok]
    return out.reshape(cap, ncols * k1)


def cube_candidates_map(key_hi: torch.Tensor, key_lo: torch.Tensor, p: torch.Tensor,
                        has: torch.Tensor, k1: int) -> torch.Tensor:
    """K4: [cap, k1^3] int32 neighbor rows (-1 absent) from the insertion
    ranks `p` int32 [k1^2 - 1, cap] and match bits `has` bool [k1^2 - 1, cap]
    of `plan._column_ranks`; see `cube_candidates_plain` for the definition."""
    if key_hi.device.type == "cpu":
        return cube_candidates_plain(key_hi, key_lo, p, has, k1)
    if key_hi.device.type != "cuda":
        raise ValueError(f"cube_candidates_map: unsupported device {key_hi.device}")
    if k1 not in (3, 5):
        raise ValueError(f"cube_candidates_map: k1 must be 3 or 5, got {k1}")
    cap = key_hi.shape[0]
    for name, t, dtype, shape in (("key_hi", key_hi, torch.int32, (cap,)),
                                  ("key_lo", key_lo, torch.int32, (cap,)),
                                  ("p", p, torch.int32, (k1 * k1 - 1, cap)),
                                  ("has", has, torch.bool, (k1 * k1 - 1, cap))):
        if t.device != key_hi.device:
            raise ValueError(f"cube_candidates_map: {name} is on {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"cube_candidates_map: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"cube_candidates_map: {name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"cube_candidates_map: {name} must be contiguous")
    nbr = torch.empty((cap, k1 ** 3), dtype=torch.int32, device=key_hi.device)
    stream = torch.cuda.current_stream(key_hi.device).cuda_stream
    _build.check(_build.library().gcd_cube_cand(
        key_hi.data_ptr(), key_lo.data_ptr(), p.data_ptr(), has.data_ptr(), nbr.data_ptr(),
        cap, k1, stream), "cube_candidates_map")
    cube_candidates_map.launches += 1
    return nbr


cube_candidates_map.launches = 0
