"""Shared training utilities: capacities, optimizer, state, batch conversion.

Port of `gcdlss_tpu/train/common.py`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.plan import build_unet_plan


def default_caps(n0: int) -> tuple:
    """Per-level voxel capacities for a stride-1 capacity n0.

    Stride-2 pooling of 5 cm LiDAR voxels sheds only ~20-40% per level, so the
    ratios 0.88 / 0.64 / 0.44 / 0.27 of n0 (rounded up to 256) keep every
    voxel of KITTI-scale scans; `plan_capacity_overflow` reports any that a
    level still drops."""

    def r(x):
        return max(256, int(-(-x // 256)) * 256)

    return (n0, r(n0 * 0.88), r(n0 * 0.64), r(n0 * 0.44), r(n0 * 0.27))


def make_sgd(cfg, params) -> torch.optim.SGD:
    """torch SGD (dampening 0, no Nesterov): weight decay added to the
    gradient, then the momentum buffer, then the learning rate, the order of
    the JAX package's optax chain. The caller sets the rate per step."""
    return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay, dampening=0.0)


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when a CUDA device is asked for (the default) and there
    is none: nothing runs on the CPU unless asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for (the default) but no CUDA device is "
            "available; pass device=\"cpu\" to run on the CPU")
    return device


class StepClock:
    """Times each step without waiting for the card: two CUDA events around a
    step on the card, the host clock on the CPU (where a step has run to its
    end when it returns). `ms()` reads the times once every event has passed,
    i.e. after the epoch's one read of the device."""

    def __init__(self, device: torch.device):
        self.on_card = device.type == "cuda"
        self.clocks: list = []

    def start(self) -> None:
        if self.on_card:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.on_card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.clocks.append((self._start, end))
        else:
            self.clocks.append((time.perf_counter() - self._t0) * 1e3)

    def ms(self) -> list:
        return [c[0].elapsed_time(c[1]) if self.on_card else c for c in self.clocks]


def voxel_batch_to_device(vb, device) -> dict:
    """VoxelBatchNp -> dict of tensors on `device`."""
    out = {
        "coords": torch.as_tensor(vb.coords, device=device),
        "feats": torch.as_tensor(vb.feats, device=device),
        "labels": torch.as_tensor(vb.labels, device=device),
        "mapped_labels": torch.as_tensor(vb.mapped_labels, device=device),
        "valid": torch.as_tensor(vb.valid, device=device),
    }
    if getattr(vb, "point_ids", None) is not None:
        out["point_ids"] = torch.as_tensor(vb.point_ids, device=device)
    return out


def point_batch_to_device(pb, device) -> dict:
    return {
        "xyz": torch.as_tensor(pb.xyz, device=device),
        "feats": torch.as_tensor(pb.feats, device=device),
        "labels": torch.as_tensor(pb.labels, device=device),
        "mapped_labels": torch.as_tensor(pb.mapped_labels, device=device),
        "valid": torch.as_tensor(pb.valid, device=device),
        "voxel_row": torch.as_tensor(pb.voxel_row, device=device),
    }


def plan_and_gather(batch: dict, caps: tuple, plan_kernel: int = 2):
    """Build the UNet plan and permute input rows into plan (sorted) order.

    Returns (plan, feats0, labels0, mapped0), where row i refers to the
    plan's level-0 row i."""
    plan = build_unet_plan(batch["coords"], batch["valid"], caps, presorted=True,
                           plan_kernel=plan_kernel)
    n = batch["coords"].shape[0]
    ok = plan.rep < n
    safe = torch.where(ok, plan.rep, 0).long()
    feats0 = batch["feats"][safe] * ok[:, None].to(batch["feats"].dtype)
    labels0 = torch.where(ok, batch["labels"][safe], -1)
    mapped0 = torch.where(ok, batch["mapped_labels"][safe], -1)
    return plan, feats0, labels0, mapped0


def inv_label_lut(label_mapping_inv: dict, num_ids: int, extra: dict | None = None) -> np.ndarray:
    """Dense LUT: compressed prediction id -> train-label id."""
    lut = np.zeros(num_ids, np.int32)
    src = dict(label_mapping_inv)
    if extra:
        src.update(extra)
    for k, v in src.items():
        if 0 <= k < num_ids:
            lut[k] = v
    return lut
