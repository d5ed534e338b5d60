"""Fixed-shape FIFO feature queue, the novel-candidate memory (PyTorch port
of `gcdlss_tpu/algo/queue.py`).

A ring buffer [slots, per_slot, dim] with per-slot counts replaces the
reference's list of tensors: a push overwrites the oldest slot, and
`queue_flatten` exposes the whole buffer with a validity mask. The head is a
tensor, so a push never waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FeatureQueue(NamedTuple):
    feats: torch.Tensor  # [slots, per_slot, dim]
    counts: torch.Tensor  # [slots] int32 valid rows per slot
    head: torch.Tensor  # int32 scalar: next slot to write


def queue_init(slots: int, per_slot: int, dim: int, dtype=torch.float32,
               device="cpu") -> FeatureQueue:
    return FeatureQueue(
        feats=torch.zeros((slots, per_slot, dim), dtype=dtype, device=device),
        counts=torch.zeros((slots,), dtype=torch.int32, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
    )


def queue_push(q: FeatureQueue, feats: torch.Tensor, valid: torch.Tensor) -> FeatureQueue:
    """Push up to per_slot valid rows of `feats` into the next slot; valid
    rows are compacted to the front in order, so truncation keeps the first
    per_slot of them. Returns a new queue; `q` is unchanged."""
    slots, per_slot, dim = q.feats.shape
    n = feats.shape[0]
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    compacted = feats[order]
    take = valid.sum().to(torch.int32).clamp(max=per_slot)
    slot_feats = torch.zeros((per_slot, dim), dtype=feats.dtype, device=feats.device)
    slot_feats[:min(n, per_slot)] = compacted[:per_slot]
    row_ok = torch.arange(per_slot, device=feats.device) < take
    slot_feats = slot_feats * row_ok[:, None].to(feats.dtype)
    head = q.head.long()[None]
    return FeatureQueue(q.feats.index_copy(0, head, slot_feats[None]),
                        q.counts.index_copy(0, head, take[None]),
                        (q.head + 1) % slots)


def queue_flatten(q: FeatureQueue):
    """Returns (feats [slots * per_slot, dim], valid [slots * per_slot])."""
    slots, per_slot, dim = q.feats.shape
    idx = torch.arange(per_slot, device=q.feats.device)[None, :]
    return q.feats.reshape(slots * per_slot, dim), (idx < q.counts[:, None]).reshape(-1)
