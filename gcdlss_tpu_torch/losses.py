"""Training losses (PyTorch port of `gcdlss_tpu/losses.py`).

  * masked cross entropy (torch `CrossEntropyLoss(ignore_index=-1)`);
  * calibration loss: the GT logit suppressed to `NEG_INF`, target the
    unknown slot;
  * mean-teacher MSE consistency on softmax probabilities;
  * the learnable-threshold hinge pair of the NCC head;
  * CE against soft targets (the feature-mixing rows of Stage 1.5).
"""

from __future__ import annotations

import torch

from .parallel.mesh import all_reduce

# finite on purpose: an infinite logit turns the CE gradient into NaN
NEG_INF = -1e9


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor | None = None, ignore_index: int = -1,
                  group=None) -> torch.Tensor:
    """Mean CE over rows with label != ignore_index (and valid, if given), f32.

    With a process `group`, the rank's share of the mean over every rank's
    rows: its own sum over the count of all ranks (`parallel.mesh`); the
    shares sum to the global mean. So do those of the losses below."""
    mask = labels != ignore_index
    if valid is not None:
        mask = mask & valid
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    m = mask.float()
    return (nll * m).sum() / all_reduce(m.sum(), group).clamp(min=1.0)


def calibration_loss(logits: torch.Tensor, labels: torch.Tensor, unknown_label: int,
                     valid: torch.Tensor | None = None, group=None) -> torch.Tensor:
    """CE towards the unknown slot with the GT class logit masked out; rows
    whose GT is the unknown slot, or negative, are ignored."""
    c = logits.shape[1]
    safe = labels.clamp(0, c - 1).long()
    onehot = torch.nn.functional.one_hot(safe, c).bool()
    masked = torch.where(onehot, torch.full_like(logits, NEG_INF), logits)
    tgt = torch.where(labels == unknown_label, -1, unknown_label)
    tgt = torch.where(labels < 0, -1, tgt)
    return cross_entropy(masked, tgt, valid, group=group)


def mse_prob_loss(probs_a: torch.Tensor, probs_b: torch.Tensor,
                  valid: torch.Tensor | None = None, group=None) -> torch.Tensor:
    """Squared error of probability rows, averaged over valid rows and all
    classes (torch `F.mse_loss`, reduction 'mean')."""
    d = (probs_a - probs_b).square()
    if valid is None:
        if group is not None:
            raise ValueError("a mean over every rank's rows needs `valid`")
        return d.mean()
    m = valid[:, None].to(d.dtype)
    return (d * m).sum() / (all_reduce(m.sum(), group) * d.shape[1]).clamp(min=1.0)


def adaptive_threshold_loss(ncc_logits: torch.Tensor, labels: torch.Tensor,
                            unknown_label: int, tau: torch.Tensor,
                            valid: torch.Tensor | None = None, group=None) -> torch.Tensor:
    """hinge(known ncc - tau) + hinge(tau - unknown ncc), each the mean over
    its set and 0 where the set is empty."""
    base = labels >= 0
    if valid is not None:
        base = base & valid
    known = base & (labels != unknown_label)
    unknown = base & (labels == unknown_label)

    def masked_mean(x, m):
        mm = m.float()
        s = all_reduce(mm.sum(), group)
        return torch.where(s > 0, (x * mm).sum() / s.clamp(min=1.0), 0.0)

    return (masked_mean(torch.relu(ncc_logits - tau), known)
            + masked_mean(torch.relu(tau - ncc_logits), unknown))


def soft_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """CE against soft target rows, f32: the mean over all rows, or over the
    valid ones."""
    nll = -(target_probs * torch.log_softmax(logits.float(), dim=-1)).sum(dim=-1)
    if valid is None:
        return nll.mean()
    m = valid.float()
    return (nll * m).sum() / m.sum().clamp(min=1.0)
