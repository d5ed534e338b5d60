"""Training losses (PyTorch port of `gcdlss_tpu/losses.py`; Stage-1 part)."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor | None = None, ignore_index: int = -1) -> torch.Tensor:
    """Mean CE over rows with label != ignore_index (and valid, if given), f32."""
    mask = labels != ignore_index
    if valid is not None:
        mask = mask & valid
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    m = mask.float()
    return (nll * m).sum() / m.sum().clamp(min=1.0)
