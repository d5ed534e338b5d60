"""RC-threshold sweep test protocol, ExpRCTest and ExpMixExtraTest
(PyTorch port of `gcdlss_tpu/eval/sweep.py`).

Rebuild of the reference's test-only modules (`modules/exp.py:3000-3290`):
forward the fine-tuned RC model over the validation set and, for each
novel-score threshold of a sweep, force the points whose NCC probability
exceeds it into the unknown slot (ExpRCTest), or split them into two novel
classes by a KMeans(2) over their backbone features (ExpMixExtraTest,
`subdivide=True`, `exp.py:3040-3055`; sklearn's KMeans when importable, else
the JAX package's fallback, a split at the median of the feature sums); then
map predictions to real-label ids and score each threshold with the
strict-Hungarian protocol (`exp.py:3108-3135`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.minkunet import assemble_dummy_logits
from ..train.common import plan_and_gather, point_batch_to_device, voxel_batch_to_device
from .metrics import strict_hungarian_iou

DEFAULT_THRESHOLDS = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8)


@torch.no_grad()
def _sweep_fwd(model, vb: dict, pb: dict, cfg):
    """One eval forward: voxel-level dummy probs and backbone features, and
    for each point its plan row, validity and label."""
    model.eval()
    plan, feats0, _, _ = plan_and_gather(vb, cfg.voxel_caps)
    out = model(plan, feats0)
    probs = torch.softmax(assemble_dummy_logits(out), dim=-1)
    n_in = vb["coords"].shape[0]
    vrow = pb["voxel_row"].reshape(-1)
    okp = vrow < n_in
    prow = plan.inverse[torch.where(okp, vrow, 0).long()]
    okp = okp & (prow < cfg.voxel_caps[0])
    srow = torch.where(okp, prow, 0)
    pvalid = pb["valid"].reshape(-1) & okp
    return probs, out["feats"], srow, pvalid, pb["labels"].reshape(-1)


def split_novel(feats: np.ndarray) -> np.ndarray:
    """ExpMixExtraTest's split of the predicted-novel rows in two
    (`exp.py:3040-3055`): KMeans(2) labels, or without scikit-learn 1 where
    a row's feature sum exceeds the median sum, else 0."""
    try:
        from sklearn.cluster import KMeans

        return KMeans(n_clusters=2, n_init="auto", random_state=0).fit_predict(feats)
    except ImportError:
        sums = feats @ np.ones(feats.shape[1])
        return (sums > np.median(sums)).astype(np.int64)


def threshold_sweep_test(model, val_dataset, cfg, label_mapping_inv: dict,
                         known_real_labels, unknown_real_labels,
                         thresholds=DEFAULT_THRESHOLDS, subdivide: bool = False,
                         num_workers: int = 0, point_cap: int | None = None) -> dict:
    """Returns {threshold: {"mIoU", "mIoU_old", "mIoU_new", "conf"}}, `conf`
    the [D, D] point confusion the IoUs come from. The model runs on its own
    device; each batch's probabilities (and, with `subdivide`, features) are
    read once.

    `subdivide=True` is ExpMixExtraTest: at each threshold the
    predicted-novel voxels are split by `split_novel` into the novel slots
    K and K + 1 (the first and second unknown real labels); otherwise all
    go to the one unknown slot (ExpRCTest)."""
    from ..data import PrefetchLoader

    K, D = cfg.num_labeled_classes, cfg.num_classes
    # train-id -> real-id LUT, the novel slots last (`exp.py:3062-3065`)
    inv = np.zeros(K + (2 if subdivide else 1), np.int64)
    for tid, real in label_mapping_inv.items():
        if 0 <= tid < K:
            inv[tid] = real
    inv[K] = unknown_real_labels[0]
    if subdivide:
        inv[K + 1] = unknown_real_labels[1 if len(unknown_real_labels) > 1 else 0]

    device = next(model.parameters()).device
    loader = PrefetchLoader(val_dataset, cfg.num_sup_scans * 2, cfg.voxel_caps[0],
                            point_cap=point_cap, shuffle=False, num_workers=num_workers,
                            drop_last=False)
    confs = {t: np.zeros((D, D), np.int64) for t in thresholds}
    for batch in loader:
        probs, feats, srow, pvalid, labels = _sweep_fwd(
            model, voxel_batch_to_device(batch["voxel"], device),
            point_batch_to_device(batch["points"], device), cfg)
        probs, srow, pvalid, labels = (t.cpu().numpy() for t in (probs, srow, pvalid, labels))
        feats = feats.cpu().numpy() if subdivide else None
        base_pred = probs.argmax(-1)  # 0..K (K = the unknown slot)
        rc = probs[:, -1]
        m = pvalid & (labels >= 0) & (labels < D)
        for t in thresholds:
            novel = rc > t
            pred = np.where(novel, K, base_pred)
            if subdivide and novel.sum() >= 2:
                pred[novel] = np.where(split_novel(feats[novel]) == 0, K, K + 1)
            np.add.at(confs[t], (inv[pred][srow][m], labels[m]), 1)

    results = {}
    for t, conf in confs.items():
        iou, _ = strict_hungarian_iou(conf, D)
        results[t] = {
            "mIoU": float(iou.mean()),
            "mIoU_old": float(iou[np.asarray(known_real_labels)].mean()),
            "mIoU_new": float(iou[np.asarray(unknown_real_labels)].mean()),
            "conf": conf,
        }
    return results
