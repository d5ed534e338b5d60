"""Supervised Cylinder3D training (PyTorch port of
`gcdlss_tpu/train/cylinder.py`, BASELINE config #4).

The working part of the reference's Cylinder3D stack: cylindrical VFE ->
Asymm3DSpconv -> CE + 3 x Lovasz at the points (reference
`models/decoder.py:182-326`), on `MultiHeadCylinder3D` with its labeled and
unlabeled prototype heads. Labels live at the points; the voxel logits reach
the points through the VFE's inverse map. The entry points run on the card
unless the caller names the CPU (`resolve_device`).

`cylinder_train_step` takes a process `group` (`parallel.mesh`): each rank
holds whole scans (`parallel.mesh.shard_scans`) and runs the model at the
model's caps, the union's (a rank's voxels at each level are a subset of
the union's, so it drops none the union keeps; every rank raises where the
union's would drop some); batch norm, the CE mean and the gradients are global, and
Lovasz, whose sort runs over every point, is computed whole on every rank
from the ranks' points gathered in rank order, which is the union's scan
order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..eval.metrics import confusion_update
from ..losses import cross_entropy
from ..models.cylinder3d import MultiHeadCylinder3D
from ..models.layers import batch_norm_group
from ..ops.lovasz import lovasz_softmax
from ..parallel.mesh import all_reduce, all_reduce_grads, gather_rows, raise_if_union_over
from .common import TrainState, make_sgd, resolve_device
from .schedule import make_lr_schedule


@dataclass(frozen=True)
class CylinderConfig:
    num_labeled_classes: int
    num_classes: int
    unknown_label: int
    num_unlabeled_classes: int = 2
    grid_shape: tuple = (240, 180, 20)
    caps: tuple = (65536, 32768, 16384, 8192, 4096)
    base_channels: int = 32
    point_cap: int = 80000
    num_scans: int = 2
    lovasz_weight: float = 3.0
    lr: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 1e-4
    use_scheduler: bool = True
    warmup_epochs: int = 4
    min_lr: float = 1e-5
    epochs: int = 50
    steps_per_epoch: int = 1000


def make_model(cfg: CylinderConfig, generator: torch.Generator | None = None
               ) -> MultiHeadCylinder3D:
    return MultiHeadCylinder3D(num_labeled=cfg.num_labeled_classes,
                               num_unlabeled=cfg.num_unlabeled_classes,
                               base_channels=cfg.base_channels, grid_shape=cfg.grid_shape,
                               caps=cfg.caps, generator=generator)


def create_cylinder_state(seed: int, cfg: CylinderConfig, device="cuda") -> TrainState:
    """Model with weights drawn from `seed` (on the CPU, then moved) and SGD,
    on the card unless `device` names another (`resolve_device`)."""
    device = resolve_device(device)
    model = make_model(cfg, torch.Generator().manual_seed(seed)).to(device)
    return TrainState(model=model, optimizer=make_sgd(cfg, model.parameters()))


def _flatten(points: dict):
    """(xyz [S*P, 3], feats [S*P, C], batch index, valid) of the [S, P] batch."""
    s, p = points["xyz"].shape[:2]
    bidx = torch.arange(s, dtype=torch.int32, device=points["xyz"].device).repeat_interleave(p)
    return (points["xyz"].reshape(s * p, 3), points["feats"].reshape(s * p, -1), bidx,
            points["valid"].reshape(-1))


def _point_logits(out: dict, pvalid: torch.Tensor):
    """The labeled logits at each point through the inverse map, and the
    points whose voxel was kept."""
    inv = out["point_inverse"]
    cap = out["logits_lab"].shape[0]
    ok = (inv < cap) & pvalid
    return out["logits_lab"][torch.where(ok, inv, 0).long()], ok


def cylinder_train_step(state: TrainState, points: dict, cfg: CylinderConfig, group=None):
    """One SGD step in place on `state`; returns (state, metrics: loss, ce,
    lovasz). `points`: xyz [S, P, 3], feats [S, P, C], mapped_labels [S, P],
    valid [S, P]; with a process `group`, this rank's whole scans, and the
    step is the one-process step on every rank's (see the module's
    docstring)."""
    model = state.model
    model.train()
    xyz, feats, bidx, pvalid = _flatten(points)
    plabels = torch.where(pvalid, points["mapped_labels"].reshape(-1), -1)
    lr = make_lr_schedule(cfg)(state.step)
    for pg in state.optimizer.param_groups:
        pg["lr"] = lr
    with batch_norm_group(group):
        out = model(xyz, feats, bidx, pvalid)
        if group is not None:
            raise_if_union_over(out["cyl_counts"], model.caps, group,
                                "the Cylinder3D trainer's plan")
        logits_pts, ok = _point_logits(out, pvalid)
        tgt = torch.where(ok & (plabels != cfg.unknown_label), plabels, -1)
        ce = cross_entropy(logits_pts, tgt, ok, group=group)
        # every rank computes the same Lovasz over the union's points: the
        # "replicated" rule hands each rank its own points' gradient once
        lv = lovasz_softmax(gather_rows(torch.softmax(logits_pts, dim=-1), group, "replicated"),
                            gather_rows(tgt, group), gather_rows(ok, group))
        loss = ce + cfg.lovasz_weight * lv
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    all_reduce_grads(model.parameters(), group)
    state.optimizer.step()
    state.step += 1
    # the ranks' CE shares summed; Lovasz is already the union's on every rank
    ce, lv = all_reduce(ce.detach(), group), lv.detach()
    return state, {"loss": ce + cfg.lovasz_weight * lv, "ce": ce, "lovasz": lv}


@torch.no_grad()
def cylinder_eval_step(state: TrainState, points: dict, inv_lut: torch.Tensor,
                       cfg: CylinderConfig) -> torch.Tensor:
    """The per-point [D, D] confusion increment over train-label ids
    (`points` as for the train step, with raw `labels`)."""
    model = state.model
    model.eval()
    xyz, feats, bidx, pvalid = _flatten(points)
    logits_pts, ok = _point_logits(model(xyz, feats, bidx, pvalid), pvalid)
    preds_raw = inv_lut[logits_pts.argmax(dim=-1)]
    return confusion_update(torch.where(ok, preds_raw, -1), points["labels"].reshape(-1),
                            cfg.num_classes, ok)
