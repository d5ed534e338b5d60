"""Key lookups against a sorted key table (the plain neighbor-map path).

Port of `gcdlss_tpu/ops/join.py`. The JAX package joins by one merged sort
because random gathers were slow on the TPU; here both functions are
`torch.searchsorted` over the int64 keys of `ops.coords.pack_keys`, with the
same results.
"""

from __future__ import annotations

import torch

from .coords import SENTINEL_HI, pack_keys


def sorted_rank(table_hi, table_lo, q_hi, q_lo) -> torch.Tensor:
    """Insertion index of each query into the sorted table: the number of
    table keys strictly below the query key, in [0, n]."""
    t = pack_keys(table_hi, table_lo)
    return torch.searchsorted(t, pack_keys(q_hi, q_lo)).to(torch.int32)


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
