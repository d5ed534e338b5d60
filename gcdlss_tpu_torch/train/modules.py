"""Host-side Stage-2 experiment module (PyTorch port of
`gcdlss_tpu/train/modules.py`): `ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive`,
the reference's `ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive`.

Two loaders at batch_size // 2 each (labeled and unlabeled), the
`discover_train_step` per pair of batches, and validation with the
discovery mIoU protocol. The loaders are the port's `data.PrefetchLoader`
with per-scan seeds: the same batches on every run, for any worker count.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data import PrefetchLoader
from ..eval.metrics import discovery_iou
from .common import (inv_label_lut, point_batch_to_device, resolve_device,
                     voxel_batch_to_device)
from .discover import (DiscoverConfig, create_discover_state, discover_eval_step,
                       discover_train_step)


class ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive:
    """Stage-2 generalized class discovery (mean teacher + LaserMix + NCC).

    `step_log` keeps one record per train step: every metric of the step
    (loss terms, tau, `n_cand`, `n_rel`, `has_novel`, `plan_overflow`, ...)
    as a float and the step's wall seconds (it ends by reading the metrics,
    which waits for the card)."""

    def __init__(self, cfg: DiscoverConfig, label_mapping: dict, label_mapping_inv: dict,
                 pretrained: dict | None = None, seed: int = 1234, device="cuda",
                 label_dict: dict | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.label_dict = label_dict or {}  # train-label id -> class name
        self.known_real_labels = [k for k, v in label_mapping.items() if v != cfg.unknown_label]
        self.unknown_real_labels = [k for k, v in label_mapping.items()
                                    if v == cfg.unknown_label]
        # novel slot i -> the i-th unknown real label
        extra = {cfg.unknown_label + i: lab for i, lab in enumerate(self.unknown_real_labels)}
        self.inv_lut = torch.as_tensor(
            inv_label_lut(label_mapping_inv,
                          cfg.num_labeled_classes + cfg.num_unlabeled_classes, extra),
            device=self.device)
        self.state = create_discover_state(seed, cfg, pretrained, self.device)
        self.step_log: list = []

    def make_loaders(self, lab_dataset, unlab_dataset, num_workers: int = 4):
        cfg = self.cfg
        lab = PrefetchLoader(lab_dataset, cfg.num_sup_scans, cfg.sup_voxel_cap,
                             point_cap=cfg.point_cap, num_workers=num_workers, seed=11)
        unlab = PrefetchLoader(unlab_dataset, cfg.num_sup_scans,
                               cfg.voxel_caps[0] - cfg.sup_voxel_cap,
                               point_cap=cfg.point_cap, num_workers=num_workers, seed=13)
        return lab, unlab

    def train_epoch(self, lab_loader, unlab_loader) -> dict:
        """One pass over the paired loaders; returns the mean of each metric."""
        logs = [self.train_step(sup, unsup) for sup, unsup in zip(lab_loader, unlab_loader)]
        if not logs:
            return {}
        return {k: float(np.mean([m[k] for m in logs])) for k in logs[0]}

    def train_step(self, sup_batch, unsup_batch) -> dict:
        t0 = time.perf_counter()
        self.state, metrics = discover_train_step(
            self.state, voxel_batch_to_device(sup_batch["voxel"], self.device),
            voxel_batch_to_device(unsup_batch["voxel"], self.device), self.cfg)
        out = {k: float(v) for k, v in metrics.items()}
        self.step_log.append({**out, "seconds": time.perf_counter() - t0})
        return out

    def validate(self, val_dataset, num_workers: int = 4, point_cap: int | None = None) -> dict:
        cfg = self.cfg
        loader = PrefetchLoader(val_dataset, cfg.num_sup_scans * 2, cfg.voxel_caps[0],
                                point_cap=point_cap or cfg.point_cap * 2, shuffle=False,
                                num_workers=num_workers, drop_last=False)
        conf = np.zeros((cfg.num_classes, cfg.num_classes), np.int64)
        for batch in loader:
            conf += discover_eval_step(
                self.state, voxel_batch_to_device(batch["voxel"], self.device),
                point_batch_to_device(batch["points"], self.device), self.inv_lut,
                cfg).cpu().numpy()
        iou, miou, miou_old, miou_new = discovery_iou(
            conf, self.known_real_labels, self.unknown_real_labels, cfg.num_classes)
        out = {"mIoU": miou, "mIoU_old": miou_old, "mIoU_new": miou_new, "iou": iou,
               "conf": conf}
        for cid, name in self.label_dict.items():
            if 0 <= cid < len(iou):
                out[f"IoU/{name}"] = float(iou[cid])
        return out


# the reference's exported module name
ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive = ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive
