"""Key lookups against a sorted key table (the plain neighbor-map path).

Port of `gcdlss_tpu/ops/join.py`. The JAX package joins by one merged sort
because random gathers were slow on the TPU; here every function is
`torch.searchsorted` over int64 keys, with the same results.
"""

from __future__ import annotations

import torch

from .coords import SENTINEL_HI, pack_keys


def sorted_rank(table_hi, table_lo, q_hi, q_lo) -> torch.Tensor:
    """Insertion index of each query into the sorted table: the number of
    table keys strictly below the query key, in [0, n]."""
    t = pack_keys(table_hi, table_lo)
    return torch.searchsorted(t, pack_keys(q_hi, q_lo)).to(torch.int32)


def sorted_rank_match(table_hi, table_lo, q_hi, q_lo, max_delta: int):
    """(p, has) per query: p is the number of table keys strictly below the
    query key, in [0, n]; `has` is True where the table key at p has the
    query's hi word and a lo delta in [0, max_delta] (the query's candidate
    run is non-empty).

    Queries may be built arithmetically (`plan._column_ranks`), so their lo
    word can be negative: keys are ordered as hi * 2^32 + lo. Both sides clamp
    lo to 2^30 - 1 as the JAX package's sort join does, which makes p and has
    equal to its values everywhere, sentinel rows included."""
    lo_max = (1 << 30) - 1
    tl = table_lo.clamp(max=lo_max)
    ql = q_lo.clamp(max=lo_max)
    t = table_hi.to(torch.int64) * (1 << 32) + tl.to(torch.int64)
    q = q_hi.to(torch.int64) * (1 << 32) + ql.to(torch.int64)
    p = torch.searchsorted(t, q)
    safe = p.clamp(max=t.shape[0] - 1)
    delta = tl[safe] - ql
    has = (p < t.shape[0]) & (table_hi[safe] == q_hi) & (delta >= 0) & (delta <= max_delta)
    return p.to(torch.int32), has


def sorted_join(table_hi, table_lo, q_hi, q_lo) -> torch.Tensor:
    """For each query key, the index of the matching table row, or -1.

    The table must be sorted and deduplicated (output of sorted_unique);
    sentinel queries never match."""
    t = pack_keys(table_hi, table_lo)
    q = pack_keys(q_hi, q_lo)
    pos = torch.searchsorted(t, q)
    safe = pos.clamp(max=t.shape[0] - 1)
    ok = (t[safe] == q) & (q_hi != SENTINEL_HI)
    return torch.where(ok, pos, -1).to(torch.int32)
