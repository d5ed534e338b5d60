"""Offline full-validation novel-class clustering evaluation (PyTorch port of
`gcdlss_tpu/eval/clustering_eval.py`).

Extract backbone features over the validation split, then discover the
novel classes by clustering instead of the trained novel head:
semi-supervised k-means anchored on the known classes' feature means
(`algo.clustering.OnlineSemiKMeans.fit_mix`), or a Sinkhorn-Knopp
assignment against k-means prototypes (`algo.sinkhorn`), scored by the
discovery Hungarian mIoU protocol.
"""

from __future__ import annotations

import numpy as np
import torch

from ..algo.clustering import OnlineSemiKMeans
from ..algo.kmeans import cosine_kmeans
from ..algo.sinkhorn import sinkhorn_knopp
from ..train.common import resolve_device
from .metrics import discovery_iou


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def extract_features(forward_fn, loader, feat_dim: int, max_voxels: int = 2_000_000):
    """Run `forward_fn(batch) -> (feats [N, C], mapped [N], labels [N],
    valid [N])` (tensors or arrays) over a loader; returns the valid rows
    stacked as numpy arrays, stopping once `max_voxels` rows are in."""
    fs, ms, ls = [], [], []
    total = 0
    for batch in loader:
        f, m, l, v = forward_fn(batch)
        v = _np(v).astype(bool)
        fs.append(_np(f)[v])
        ms.append(_np(m)[v])
        ls.append(_np(l)[v])
        total += int(v.sum())
        if total >= max_voxels:
            break
    return np.concatenate(fs), np.concatenate(ms), np.concatenate(ls)


def clustering_discovery_eval(feats: np.ndarray, mapped_labels: np.ndarray,
                              real_labels: np.ndarray, unknown_label: int, known_real_labels,
                              unknown_real_labels, num_classes: int, label_mapping_inv: dict,
                              method: str = "semi_kmeans", seed: int = 0, device="cuda",
                              picks=None, scores=None) -> dict:
    """Cluster the features whose mapped label is the unknown slot into
    #unknown groups and score with the discovery protocol; the other voxels
    keep their (mapped -> real) labels as predictions.

    Runs on the card unless `device` names another. The draws come from
    `seed` unless given: `picks` the k-means++ rows of `semi_kmeans`
    (`OnlineSemiKMeans.fit_mix`), `scores` the k-means initial-row draw of
    `sinkhorn` (one uniform per unknown row)."""
    device = resolve_device(device)
    num_unknown = len(unknown_real_labels)
    is_unknown = mapped_labels == unknown_label
    u_feats = feats[is_unknown]
    l_feats = feats[~is_unknown]
    l_targets = mapped_labels[~is_unknown]

    if method == "semi_kmeans":
        n_known = int(l_targets.max()) + 1
        km = OnlineSemiKMeans(k=n_known + num_unknown, max_iterations=50, n_init=1, seed=seed,
                              device=device)
        all_labels = km.fit_mix(u_feats, l_feats, l_targets,
                                picks=None if picks is None else [picks])
        u_assign = np.clip(all_labels[l_feats.shape[0]:] - n_known, 0, num_unknown - 1)
    elif method == "sinkhorn":
        # prototypes: the unknown rows' own cosine k-means centroids
        u = torch.as_tensor(u_feats, dtype=torch.float32, device=device)
        if scores is None:
            scores = torch.rand(u.shape[0], device=device,
                                generator=torch.Generator(device=device).manual_seed(seed))
        _, cents = cosine_kmeans(u, torch.ones(u.shape[0], dtype=torch.bool, device=device),
                                 num_unknown, torch.as_tensor(_np(scores), device=device))
        u_assign = sinkhorn_knopp(u, cents.T).argmax(dim=-1).cpu().numpy()
    else:
        raise ValueError(method)

    # point-level predictions in the real-label space
    inv_lut = np.zeros(max(label_mapping_inv.keys()) + 1, np.int32)
    for k, v in label_mapping_inv.items():
        if k >= 0:
            inv_lut[k] = v
    preds = np.empty(feats.shape[0], np.int32)
    preds[~is_unknown] = inv_lut[np.clip(l_targets, 0, inv_lut.shape[0] - 1)]
    preds[is_unknown] = np.asarray(list(unknown_real_labels))[u_assign]

    conf = np.zeros((num_classes, num_classes), np.int64)
    ok = (real_labels >= 0) & (real_labels < num_classes)
    np.add.at(conf, (preds[ok], real_labels[ok]), 1)
    iou, miou, miou_old, miou_new = discovery_iou(conf, known_real_labels, unknown_real_labels,
                                                  num_classes)
    return {"mIoU": miou, "mIoU_old": miou_old, "mIoU_new": miou_new, "iou": iou, "conf": conf}
