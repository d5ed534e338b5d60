"""Evaluation: confusion matrix, IoU and the Stage-1 strict-Hungarian protocol.

Port of `gcdlss_tpu/eval/metrics.py` (Stage-1 part): `confusion_update` runs
on tensors on the device, the rest on small numpy matrices on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_update(preds: torch.Tensor, labels: torch.Tensor, num_classes: int,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """[D, D] int64 counts with conf[pred, label] += 1 over valid rows."""
    mask = (labels >= 0) & (labels < num_classes) & (preds >= 0) & (preds < num_classes)
    if valid is not None:
        mask = mask & valid
    idx = (preds.long() * num_classes + labels.long())[mask]
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def get_iou(conf_matrix: np.ndarray, include=None) -> np.ndarray:
    conf = conf_matrix.astype(np.float64)
    tp = conf.diagonal()
    fp = conf.sum(axis=1) - tp
    fn = conf.sum(axis=0) - tp
    iou = tp / np.maximum(tp + fp + fn, 1e-15)
    return iou if include is None else iou[include]


def hungarian(cost: np.ndarray):
    """Max-assignment indices via scipy."""
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(cost.max() - cost)


def strict_hungarian_iou(conf: np.ndarray, num_classes: int):
    """Stage-1 protocol: full-matrix Hungarian, then per-class IoU."""
    row_ind, col_ind = hungarian(conf)
    ind = np.vstack([row_ind, col_ind]).T
    permuted = conf[:, ind[:, 1]]
    include = np.argsort(ind[:, 1])[:num_classes]
    return get_iou(permuted, include), include
