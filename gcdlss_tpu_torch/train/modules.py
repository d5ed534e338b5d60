"""Host-side Stage-2 experiment module (PyTorch port of
`gcdlss_tpu/train/modules.py`): `ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive`,
the reference's `ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive`.

Two loaders at batch_size // 2 each (labeled and unlabeled), the
`discover_train_step` per pair of batches, validation with the discovery
mIoU protocol, `test` (validation, PLY dumps of predictions and ground truth,
a confusion-matrix PNG) and `fit` (epochs of training and validation, a
metrics log and a checkpoint an epoch, keyed by the step). The loaders are
the port's `data.PrefetchLoader` with per-scan seeds: the same batches on
every run, for any worker count.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data import PrefetchLoader, collate_batch
from ..eval.metrics import discovery_iou
from ..models.minkunet import assemble_novel_logits
from .common import (StepClock, inv_label_lut, plan_and_gather, point_batch_to_device,
                     resolve_device, voxel_batch_to_device)
from .discover import (DiscoverConfig, create_discover_state, discover_eval_step,
                       discover_train_step)


class ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive:
    """Stage-2 generalized class discovery (mean teacher + LaserMix + NCC).

    Every recipe of the discovery family runs through it, its variant in the
    config (`train.discover`). `step_log` keeps one record per train step:
    every metric of the step (loss terms, tau, `n_cand`, `n_rel`,
    `has_novel`, `plan_overflow`, ...) as a float, the step's wall seconds
    (it ends by reading the metrics, which waits for the card) and its
    device time `step_ms` (two CUDA events; the host clock on the CPU)."""

    def __init__(self, cfg: DiscoverConfig, label_mapping: dict, label_mapping_inv: dict,
                 pretrained: dict | None = None, seed: int = 1234, device="cuda",
                 label_dict: dict | None = None, logger=None, checkpoint_manager=None):
        self.cfg = cfg
        self.logger = logger  # utils.logging.MetricsLogger or None
        self.ckpt = checkpoint_manager  # train.checkpoint.CheckpointManager or None
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
        clock = StepClock(self.device)
        clock.start()
        dev = self.device
        self.state, metrics = discover_train_step(
            self.state, voxel_batch_to_device(sup_batch["voxel"], dev),
            voxel_batch_to_device(unsup_batch["voxel"], dev), self.cfg,
            sup_pb=point_batch_to_device(sup_batch["points"], dev),
            unsup_pb=point_batch_to_device(unsup_batch["points"], dev))
        clock.stop()
        out = {k: float(v) for k, v in metrics.items()}
        self.step_log.append({**out, "seconds": time.perf_counter() - t0,
                              "step_ms": clock.ms()[0]})
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

    def test(self, val_dataset, num_workers: int = 4, visualize: bool = False,
             save_dir: str | None = None, confusion_png: str | None = None) -> dict:
        """The test protocol (`exp_merge_mean_teacher.py:2412-2560`): `validate`;
        with `visualize`, PLY files of the teacher's voxel predictions and the
        ground truth for the first 4 scans into `save_dir`
        (`utils.visualize`); with `confusion_png`, the confusion matrix as a
        PNG (needs matplotlib, imported only then: ImportError without it)."""
        from ..utils.visualize import get_color, write_ply

        result = self.validate(val_dataset, num_workers)
        if visualize and save_dir:
            os.makedirs(save_dir, exist_ok=True)
            cfg, teacher = self.cfg, self.state.teacher
            teacher.eval()
            for i in range(min(len(val_dataset), 4)):
                s = val_dataset[i]
                batch = collate_batch([s], cfg.voxel_caps[0], point_cap=cfg.point_cap)
                vb = voxel_batch_to_device(batch["voxel"], self.device)
                with torch.no_grad():
                    plan, feats0, labels0, _ = plan_and_gather(vb, cfg.voxel_caps,
                                                               cfg.plan_kernel)
                    logits = assemble_novel_logits(teacher(plan, feats0))
                preds = self.inv_lut[logits[:, :-1].argmax(dim=-1)].cpu().numpy()
                coords = plan.levels[0].coords[:, 1:].cpu().numpy().astype(np.float32)
                valid = plan.levels[0].valid.cpu().numpy()
                labels = labels0.cpu().numpy()
                name = os.path.join(save_dir, f"{s.scan_idx:06d}")
                fields = ["x", "y", "z", "red", "green", "blue"]
                write_ply(name + "-gt.ply", [coords[valid], get_color(labels[valid])], fields)
                write_ply(name + "-pd.ply", [coords[valid], get_color(preds[valid])], fields)
        if confusion_png:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(12, 12))
            ax.imshow(result["conf"], cmap="Blues")
            ax.set_xlabel("True Label")
            ax.set_ylabel("Predicted Label")
            ax.set_title("Confusion Matrix")
            fig.tight_layout()
            fig.savefig(confusion_png, dpi=120)
            plt.close(fig)
        return result

    def fit(self, lab_dataset, unlab_dataset, val_dataset=None, epochs: int = 1,
            num_workers: int = 4, validate_every: int = 1) -> list:
        """`epochs` passes over the paired loaders, `validate` every
        `validate_every` epochs; each epoch's record goes to the logger and
        the state to the checkpoint manager, keyed by the step, as the JAX
        package's `fit` does. Returns one record an epoch."""
        history = []
        lab_loader, unlab_loader = self.make_loaders(lab_dataset, unlab_dataset, num_workers)
        for epoch in range(epochs):
            tm = self.train_epoch(lab_loader, unlab_loader)
            rec = {"epoch": epoch, **{f"train/{k}": v for k, v in tm.items()}}
            if val_dataset is not None and (epoch + 1) % validate_every == 0:
                vm = self.validate(val_dataset, num_workers)
                rec.update({f"valid/{k}": v for k, v in vm.items() if k not in ("iou", "conf")})
            history.append(rec)
            if self.logger is not None:
                self.logger.log_dict({k: v for k, v in rec.items()
                                      if isinstance(v, (float, np.floating))}, epoch)
            if self.ckpt is not None:
                self.ckpt.save(int(self.state.step), self.state)
        return history


# the reference's exported module name
ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive = ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive
