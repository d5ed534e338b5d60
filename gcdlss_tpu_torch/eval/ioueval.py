"""Streaming IoU evaluator with unknown-score collection (port of
`gcdlss_tpu/eval/ioueval.py`, itself a rebuild of the reference's
`utils/ioueval.py`).

Besides the confusion matrix it keeps the per-point "unknown" scores, split
by whether the ground truth is a known or the unknown class, to study the
NCC threshold. Plain numpy on the host; on the device the confusion goes
through `eval.metrics.confusion_update`.
"""

from __future__ import annotations

import numpy as np

from .metrics import get_iou


class IoUEval:
    def __init__(self, n_classes: int, ignore=(), unknown: int | None = None):
        self.n_classes = n_classes
        self.ignore = set(np.atleast_1d(ignore).tolist()) if ignore != () else set()
        self.include = [c for c in range(n_classes) if c not in self.ignore]
        self.unknown = unknown
        self.reset()

    def reset(self):
        self.conf = np.zeros((self.n_classes, self.n_classes), np.int64)
        self.known_scores: list = []
        self.unknown_scores: list = []

    def add_batch(self, preds, labels, unknown_scores=None):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        mask = (labels >= 0) & (labels < self.n_classes)
        mask &= (preds >= 0) & (preds < self.n_classes)
        np.add.at(self.conf, (preds[mask], labels[mask]), 1)
        if unknown_scores is not None and self.unknown is not None:
            s = np.asarray(unknown_scores).reshape(-1)
            is_unk = labels == self.unknown
            self.known_scores.append(s[mask & ~is_unk])
            self.unknown_scores.append(s[mask & is_unk])

    def get_confusion(self):
        return self.conf.copy()

    def get_iou(self):
        iou = get_iou(self.conf)
        return float(np.mean(iou[self.include])), iou

    def get_acc(self):
        tp = self.conf.diagonal()[self.include].sum()
        return float(tp / max(self.conf[self.include].sum(), 1))

    def get_unknown_score_stats(self):
        k = np.concatenate(self.known_scores) if self.known_scores else np.zeros(0)
        u = np.concatenate(self.unknown_scores) if self.unknown_scores else np.zeros(0)
        return {
            "known_mean": float(k.mean()) if k.size else float("nan"),
            "unknown_mean": float(u.mean()) if u.size else float("nan"),
            "known_scores": k,
            "unknown_scores": u,
        }
