"""Small utilities (PyTorch port of `gcdlss_tpu/utils/misc.py`, the
reference's `utils/utils.py:9-97`)."""

from __future__ import annotations

import numpy as np
import torch


class TransformTwice:
    """Apply a transform twice to produce two augmented views."""

    def __init__(self, transform):
        self.transform = transform

    def __call__(self, inp):
        return self.transform(inp), self.transform(inp)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def cluster_acc(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Clustering accuracy with the best label permutation (Hungarian)."""
    from scipy.optimize import linear_sum_assignment

    y_true = y_true.astype(np.int64)
    y_pred = y_pred.astype(np.int64)
    d = max(y_pred.max(), y_true.max()) + 1
    w = np.zeros((d, d), np.int64)
    np.add.at(w, (y_pred, y_true), 1)
    row, col = linear_sum_assignment(w.max() - w)
    return float(w[row, col].sum()) / max(y_pred.size, 1)


def entropy(probs) -> torch.Tensor:
    """Mean entropy of a batch of probability rows (numpy array or tensor)."""
    p = torch.as_tensor(probs).clamp(1e-8, 1.0)
    return -(p * torch.log(p)).sum(dim=-1).mean()


def margin_loss(logits: torch.Tensor, labels: torch.Tensor, margin: float = 10.0,
                weight: torch.Tensor | None = None) -> torch.Tensor:
    """Large-margin CE: `margin` taken off the GT logit before the softmax;
    rows with a negative label are left out."""
    c = logits.shape[-1]
    safe = labels.clamp(0, c - 1).long()
    adj = logits - margin * torch.nn.functional.one_hot(safe, c).to(logits.dtype)
    nll = -torch.log_softmax(adj, dim=-1).gather(1, safe[:, None])[:, 0]
    if weight is not None:
        nll = nll * weight[safe]
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
