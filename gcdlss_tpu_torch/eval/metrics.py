"""Evaluation: confusion matrix, IoU, and the Stage-1 and Stage-2 protocols.

Port of `gcdlss_tpu/eval/metrics.py`: `confusion_update` runs on tensors on
the device, the protocols and the streaming `SemanticEval` on small numpy
matrices on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_update(preds: torch.Tensor, labels: torch.Tensor, num_classes: int,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """[D, D] int64 counts with conf[pred, label] += 1 over valid rows.

    Masked rows count into a spare bucket that is dropped, so the shapes are
    fixed and the device never waits for the host."""
    d = num_classes
    mask = (labels >= 0) & (labels < d) & (preds >= 0) & (preds < d)
    if valid is not None:
        mask = mask & valid
    idx = torch.where(mask, preds.long() * d + labels.long(), d * d)
    flat = torch.zeros(d * d + 1, dtype=torch.int64, device=idx.device)
    flat.scatter_add_(0, idx, torch.ones_like(idx))
    return flat[:-1].reshape(d, d)


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


def discovery_iou(conf: np.ndarray, known_ids, unknown_ids, num_classes: int):
    """Stage-2 protocol: Hungarian only over the unknown x unknown submatrix,
    then the matching column permutation. Returns (iou [num_classes], mIoU,
    mIoU over the known classes, mIoU over the unknown ones)."""
    conf = conf.copy()
    unknown_ids = np.asarray(list(unknown_ids))
    known_ids = np.asarray(list(known_ids))
    _, col_ind = hungarian(conf[np.ix_(unknown_ids, unknown_ids)])
    conf[:, unknown_ids] = conf[:, unknown_ids[col_ind]]
    include = np.arange(num_classes)
    include[unknown_ids] = unknown_ids[np.argsort(col_ind)]
    iou = get_iou(conf, include)
    return iou, float(iou.mean()), float(iou[known_ids].mean()), float(iou[unknown_ids].mean())


class SemanticEval:
    """Streaming numpy confusion / IoU evaluator (cf. the reference's
    `utils/eval.py`, `utils/np_ioueval.py`)."""

    def __init__(self, num_classes: int, ignore=()):
        self.num_classes = num_classes
        self.ignore = set(ignore)
        self.include = [c for c in range(num_classes) if c not in self.ignore]
        self.reset()

    def reset(self):
        self.conf = np.zeros((self.num_classes, self.num_classes), np.int64)

    def add_batch(self, preds: np.ndarray, labels: np.ndarray):
        mask = (labels >= 0) & (labels < self.num_classes)
        mask &= (preds >= 0) & (preds < self.num_classes)
        np.add.at(self.conf, (preds[mask], labels[mask]), 1)

    def get_sem_iou(self):
        iou = get_iou(self.conf)
        return float(np.mean(iou[self.include])), iou

    def get_sem_acc(self):
        tp = self.conf.diagonal()[self.include].sum()
        return float(tp / max(self.conf[self.include].sum(), 1))
