"""Integer voxel coordinates: key packing and sorted-unique (PyTorch).

Port of `gcdlss_tpu/ops/coords.py`. Coordinates are `(batch, x, y, z)` int32
in stride units, packed into the same `(hi, lo)` int32 pair as the JAX
package:

    hi = b * FIELD + (x + COORD_OFFSET)
    lo = (y + COORD_OFFSET) * FIELD + (z + COORD_OFFSET)

For sorting and searching the pair is packed into one int64 key,
`hi << 32 | lo`; both words are non-negative, so int64 order is the
lexicographic `(hi, lo)` order and the sentinel pair sorts last.
"""

from __future__ import annotations

import torch

FIELD = 1 << 15
COORD_OFFSET = 1 << 14
SENTINEL_HI = (1 << 31) - 1
SENTINEL_LO = (1 << 31) - 1


def encode_coords(coords: torch.Tensor, valid: torch.Tensor):
    """Pack [N, 4] int32 (b, x, y, z) into (hi, lo) int32 keys.

    Invalid rows get the sentinel key. Spatial coords are clipped into the
    representable field (±16383 stride units)."""
    b = coords[:, 0].to(torch.int32)
    xyz = (coords[:, 1:4].to(torch.int32) + COORD_OFFSET).clamp(0, FIELD - 1)
    hi = torch.where(valid, b * FIELD + xyz[:, 0], SENTINEL_HI).to(torch.int32)
    lo = torch.where(valid, xyz[:, 1] * FIELD + xyz[:, 2], SENTINEL_LO).to(torch.int32)
    return hi, lo


def decode_keys(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of encode_coords -> [N, 4] int32. Sentinel rows undefined."""
    b = torch.div(hi, FIELD, rounding_mode="floor")
    x = hi % FIELD - COORD_OFFSET
    y = torch.div(lo, FIELD, rounding_mode="floor") - COORD_OFFSET
    z = lo % FIELD - COORD_OFFSET
    return torch.stack([b, x, y, z], dim=1).to(torch.int32)


def pack_keys(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) int32 -> int64 keys in the same order."""
    return (hi.to(torch.int64) << 32) | lo.to(torch.int64)


def _unique_from_sorted(sk: torch.Tensor, order: torch.Tensor, capacity: int):
    """Group sorted int64 keys; `order[p]` is the input row at sorted position
    p (n where no input row sits). Returns the uniques, `rep` and the group id
    per sorted position clamped to `capacity`."""
    n = sk.shape[0]
    dev = sk.device
    sentinel = (SENTINEL_HI << 32) | SENTINEL_LO
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    gid = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    valid_sorted = sk != sentinel
    count = (first & valid_sorted).sum().to(torch.int32)
    keep = valid_sorted & (gid < capacity)
    gid_clamped = torch.where(keep, gid, capacity).to(torch.int32)
    # the first row of each group is its first occurrence (stable order). Every
    # sorted position writes: a head to its group's slot, the rest to one slot
    # past the end, which is dropped (a boolean index would wait for its count)
    slot = torch.where(first & keep, gid, capacity).long()
    uniq = torch.full((capacity + 1,), sentinel, dtype=torch.int64, device=dev)
    rep = torch.full((capacity + 1,), n, dtype=torch.int32, device=dev)
    uniq[slot] = sk
    rep[slot] = order.to(torch.int32)
    uniq, rep = uniq[:capacity], rep[:capacity]
    uh = (uniq >> 32).to(torch.int32)
    ul = (uniq & 0xFFFFFFFF).to(torch.int32)
    return (uh, ul), rep, gid_clamped, count


def sorted_unique(hi: torch.Tensor, lo: torch.Tensor, capacity: int):
    """Sorted unique over packed keys with a static output capacity.

    Returns ((uniq_hi, uniq_lo) [capacity] sentinel-padded, rep [capacity]
    first-occurrence input row (n for padding), inverse [n] output row per
    input row (capacity where dropped or invalid), count: the true number of
    valid unique keys before the capacity clamp)."""
    n = hi.shape[0]
    sk, order = torch.sort(pack_keys(hi, lo), stable=True)
    (uh, ul), rep, gid_clamped, count = _unique_from_sorted(sk, order, capacity)
    inverse = torch.empty(n, dtype=torch.int32, device=hi.device)
    inverse[order] = gid_clamped
    return (uh, ul), rep, inverse, count


def sorted_unique_nodup(hi: torch.Tensor, lo: torch.Tensor, capacity: int):
    """`sorted_unique` for keys promised duplicate-free, with capacity == n
    (the voxel-level LaserMix re-batch): the unique keys are the sorted keys,
    `rep` is the stable sort order and `inverse` scatters the positions back.
    A broken promise leaves both copies of a key in two rows. Same returns as
    `sorted_unique`."""
    n = hi.shape[0]
    if capacity != n:
        raise ValueError(f"sorted_unique_nodup needs capacity == n, got {capacity} != {n}")
    sk, order = torch.sort(pack_keys(hi, lo), stable=True)
    sh = (sk >> 32).to(torch.int32)
    sl = (sk & 0xFFFFFFFF).to(torch.int32)
    valid_sorted = sh != SENTINEL_HI
    pos = torch.arange(n, dtype=torch.int32, device=hi.device)
    rep = torch.where(valid_sorted, order, n).to(torch.int32)
    inverse = torch.empty(n, dtype=torch.int32, device=hi.device)
    inverse[order] = torch.where(valid_sorted, pos, capacity).to(torch.int32)
    return (sh, sl), rep, inverse, valid_sorted.sum().to(torch.int32)


def sorted_unique_presorted(hi: torch.Tensor, lo: torch.Tensor, capacity: int):
    """`sorted_unique` for inputs whose valid rows are already key-sorted
    (host quantize output and its batch concatenation): a validity compaction
    replaces the sort. Same returns as `sorted_unique`."""
    n = hi.shape[0]
    dev = hi.device
    valid = hi != SENTINEL_HI
    # the valid rows, compacted in order: row i goes to position pos[i]; the
    # invalid rows all write one slot past the end, which is dropped
    pos = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(valid, pos, n).long()
    sentinel = (SENTINEL_HI << 32) | SENTINEL_LO
    sk = torch.full((n + 1,), sentinel, dtype=torch.int64, device=dev)
    sk[slot] = pack_keys(hi, lo)
    order = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    order[slot] = torch.arange(n, dtype=torch.int64, device=dev)
    (uh, ul), rep, gid_clamped, count = _unique_from_sorted(sk[:n], order[:n], capacity)
    inverse = torch.where(valid, gid_clamped[slot.clamp(max=n - 1)], capacity).to(torch.int32)
    return (uh, ul), rep, inverse, count


def lookup_sorted(uniq_hi: torch.Tensor, uniq_lo: torch.Tensor, q_hi: torch.Tensor,
                  q_lo: torch.Tensor) -> torch.Tensor:
    """Row of each (q_hi, q_lo) query key in a sorted, sentinel-padded key
    table (the output of `sorted_unique`), or -1 where the key is absent or
    is the sentinel. Any query shape; int32 result. One `searchsorted` on the
    packed keys gives the first row whose key is not below the query, the
    lower bound the JAX package's binary search converges to."""
    cap = uniq_hi.shape[0]
    table = pack_keys(uniq_hi, uniq_lo)
    q = pack_keys(q_hi, q_lo)
    pos = torch.searchsorted(table, q.reshape(-1)).reshape(q.shape).clamp(max=cap - 1)
    found = (table[pos] == q) & (q_hi != SENTINEL_HI)
    return torch.where(found, pos, -1).to(torch.int32)
