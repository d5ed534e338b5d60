"""Learning-rate schedules (PyTorch port of `gcdlss_tpu/train/schedule.py`).

`warmup_cosine_lr` is the closed form of the lightning-bolts
LinearWarmupCosineAnnealingLR the reference steps once per epoch
(`utils/scheduler.py:105-119`): linear from `warmup_start_lr` to `base_lr`
over `warmup_epochs`, then cosine to `eta_min` at `max_epochs`.
"""

from __future__ import annotations

import math


def warmup_cosine_lr(epoch: int, base_lr: float, warmup_epochs: int, max_epochs: int,
                     warmup_start_lr: float = 0.0, eta_min: float = 0.0) -> float:
    if epoch < warmup_epochs:
        return warmup_start_lr + epoch * (base_lr - warmup_start_lr) / max(warmup_epochs - 1, 1)
    span = max(max_epochs - warmup_epochs, 1)
    return eta_min + 0.5 * (base_lr - eta_min) * (
        1.0 + math.cos(math.pi * (epoch - warmup_epochs) / span))


def make_lr_schedule(cfg):
    """step -> lr, stepping per epoch like the reference (PL default)."""

    def schedule(step: int) -> float:
        if not cfg.use_scheduler:
            return cfg.lr
        epoch = step // max(cfg.steps_per_epoch, 1)
        return warmup_cosine_lr(epoch, cfg.lr, cfg.warmup_epochs, cfg.epochs,
                                warmup_start_lr=cfg.min_lr, eta_min=cfg.min_lr)

    return schedule
