"""Stage-1 supervised pretraining (the reference's `ExpPretrain`), PyTorch.

Port of `gcdlss_tpu/train/pretrain.py`. One train step: build the plan ->
MinkUNet forward -> masked CE over the known classes -> backward -> SGD
(momentum, weight decay) at the per-epoch warmup-cosine rate. Eval follows
the reference protocol (`modules/exp.py:277-334`): voxel predictions expanded
to points through the inverse map, known-class filtering, a confusion matrix
over train-label ids, strict Hungarian at the end.

The reference's Stage-1 head has K outputs while its loader keeps
unknown-class points with target K; as in the JAX package, that slot is
ignored by the loss.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..eval.metrics import confusion_update, strict_hungarian_iou
from ..losses import cross_entropy
from ..models.layers import batch_norm_group
from ..models.minkunet import DEFAULT_PLANES, MinkUNetSeg
from ..ops.plan import plan_capacity_overflow
from ..parallel.mesh import all_reduce, all_reduce_grads, rank_caps
from .common import (StepClock, TrainState, inv_label_lut, make_sgd, plan_and_gather,
                     point_batch_to_device, resolve_device, voxel_batch_to_device)
from .schedule import make_lr_schedule


@dataclass(frozen=True)
class PretrainConfig:
    num_labeled_classes: int
    num_classes: int
    unknown_label: int
    voxel_caps: tuple
    arch: str = "MinkUNet34"
    planes: tuple = DEFAULT_PLANES
    in_channels: int = 1
    dtype: str = "float32"  # activation dtype: "bfloat16" on the card
    remat: bool = False  # recompute each residual block's forward in backward
    head: str = "linear"  # "cosine" = ExpCosinePretrain (`NormedLinear` head)
    lr: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 1e-4
    use_scheduler: bool = True
    warmup_epochs: int = 4
    min_lr: float = 1e-5
    epochs: int = 50
    steps_per_epoch: int = 1000


def make_model(cfg: PretrainConfig, generator: torch.Generator | None = None) -> MinkUNetSeg:
    return MinkUNetSeg(cfg.num_labeled_classes, arch=cfg.arch, planes=cfg.planes,
                       in_channels=cfg.in_channels, dtype=getattr(torch, cfg.dtype),
                       generator=generator, head=cfg.head, remat=cfg.remat)


def create_pretrain_state(seed: int, cfg: PretrainConfig, device="cuda") -> TrainState:
    """Model with weights drawn from `seed` (on the CPU, then moved) and SGD,
    on the card unless `device` names another (`resolve_device`)."""
    device = resolve_device(device)
    model = make_model(cfg, torch.Generator().manual_seed(seed)).to(device)
    return TrainState(model=model, optimizer=make_sgd(cfg, model.parameters()))


def pretrain_train_step(state: TrainState, batch: dict, cfg: PretrainConfig, group=None,
                        shard=None):
    """One SGD step in place on `state`; returns (state, metrics).

    With a process `group` (`parallel.mesh`), `batch` is this rank's whole
    scans (`shard_voxel_batch`) and the step is the one-process step on
    every rank's scans: plans at the rank's share of the capacities,
    batch-norm statistics and the CE mean over all ranks' rows, gradients
    summed over the ranks, the metrics global (the plan overflow summed).

    `shard`: the seam of the voxel-sharded step (`parallel.sp_step`). Then
    `batch` is the whole batch of the rank's ring at cfg's capacities, and
    shard(plan) gives the rank's sharded plan, its level-0 rows and the
    weight of the plan's overflow in the summed count (one plan a ring);
    the metrics gain the windows' dropped entries, `sp_overflow`."""
    model = state.model
    model.train()
    caps = cfg.voxel_caps if shard else rank_caps(cfg.voxel_caps, group)
    plan, feats0, _, mapped0 = plan_and_gather(batch, caps)
    # the unknown slot has no logit in Stage 1 -> ignore those targets
    targets = torch.where(mapped0 == cfg.unknown_label, -1, mapped0)
    run_plan, rows, weight = shard(plan) if shard else (plan, slice(None), None)
    lr = make_lr_schedule(cfg)(state.step)
    for pg in state.optimizer.param_groups:
        pg["lr"] = lr
    with batch_norm_group(group):
        out = model(run_plan, feats0[rows])
        loss = cross_entropy(out["logits"], targets[rows], run_plan.levels[0].valid,
                             group=group)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    all_reduce_grads(model.parameters(), group)
    state.optimizer.step()
    state.step += 1
    plan_ovf = plan_capacity_overflow(plan)
    metrics = {"loss": all_reduce(loss.detach(), group)}
    if shard:
        metrics["sp_overflow"] = all_reduce(out["sp_overflow"], group)
        plan_ovf = plan_ovf * weight
    metrics["plan_overflow"] = all_reduce(plan_ovf, group)
    return state, metrics


@torch.no_grad()
def pretrain_eval_step(state: TrainState, batch: dict, points: dict,
                       inv_lut: torch.Tensor, cfg: PretrainConfig):
    """Returns (confusion increment [D, D], masked validation loss)."""
    model = state.model
    model.eval()
    plan, feats0, _, mapped0 = plan_and_gather(batch, cfg.voxel_caps)
    valid0 = plan.levels[0].valid
    logits = model(plan, feats0)["logits"]
    mask_lab = (mapped0 != cfg.unknown_label) & (mapped0 >= 0) & valid0
    loss = cross_entropy(logits, torch.where(mask_lab, mapped0, -1), valid0)

    voxel_pred_raw = inv_lut[logits.argmax(dim=-1)]  # -> train-label ids
    # expand to points: original batch rows -> plan rows
    cap0 = batch["coords"].shape[0]
    vrow = points["voxel_row"].reshape(-1)
    ok = vrow < cap0
    plan_row = torch.where(ok, plan.inverse[torch.where(ok, vrow, 0).long()], cap0)
    ok = ok & (plan_row < cap0)
    safe_row = torch.where(ok, plan_row, 0).long()
    point_pred = torch.where(ok, voxel_pred_raw[safe_row], -1)
    point_known = ok & mask_lab[safe_row]
    pvalid = points["valid"].reshape(-1) & point_known
    conf = confusion_update(point_pred, points["labels"].reshape(-1), cfg.num_classes, pvalid)
    return conf, loss


class ExpPretrain:
    """Host-side orchestration for Stage 1 (epochs, eval), like the
    reference's `ExpPretrain` LightningModule (`modules/exp.py:71-361`).

    `step_log` keeps one record per train step: loss, plan overflow and
    `step_ms`, the step's time on the device between two CUDA events (on the
    CPU, where a step runs to its end before it returns: the host clock).
    Like the reference, an epoch reads the device once, at its end: the
    losses, overflows and events stay on the card until then.
    """

    def __init__(self, cfg: PretrainConfig, label_mapping: dict, label_mapping_inv: dict,
                 seed: int = 1234, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.known_real_labels = [k for k, v in label_mapping.items() if v != cfg.unknown_label]
        self.inv_lut = torch.as_tensor(
            inv_label_lut(label_mapping_inv, cfg.num_labeled_classes), device=self.device)
        self.state = create_pretrain_state(seed, cfg, self.device)
        self.step_log: list = []

    def train_epoch(self, loader) -> float:
        losses, overflows = [], []
        clock = StepClock(self.device)
        for batch in loader:
            clock.start()
            vb = voxel_batch_to_device(batch["voxel"], self.device)
            self.state, metrics = pretrain_train_step(self.state, vb, self.cfg)
            clock.stop()
            losses.append(metrics["loss"])
            overflows.append(metrics["plan_overflow"])
        if not losses:
            return float("nan")
        # the epoch's one read of the device (overflow counts are exact in f32);
        # every event has passed once it returns
        loss_v, overflow_v = torch.stack([torch.stack(losses).float(),
                                          torch.stack(overflows).float()]).cpu().numpy()
        for loss, overflow, ms in zip(loss_v, overflow_v, clock.ms()):
            self.step_log.append({"loss": float(loss), "plan_overflow": int(overflow),
                                  "step_ms": ms})
        return float(np.mean(loss_v, dtype=np.float64))

    def validate(self, loader) -> dict:
        d = self.cfg.num_classes
        conf = np.zeros((d, d), np.int64)
        losses = []
        for batch in loader:
            vb = voxel_batch_to_device(batch["voxel"], self.device)
            pb = point_batch_to_device(batch["points"], self.device)
            c, loss = pretrain_eval_step(self.state, vb, pb, self.inv_lut, self.cfg)
            conf += c.cpu().numpy()
            losses.append(float(loss))
        iou, _ = strict_hungarian_iou(conf, d)
        return {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "mIoU": float(iou.mean()),
            "mIoU_old": float(iou[self.known_real_labels].mean()),
            "iou": iou,
            "conf": conf,
        }
