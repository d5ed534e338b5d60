"""ExpUncertaintyCheck: rank unlabeled scans by prediction entropy (PyTorch
port of `gcdlss_tpu/train/uncertainty.py`).

Rebuild of `modules/exp.py:2799-2998`: a warm-started `MinkUNetRC` scores
every unlabeled scan by the mean softmax entropy of its dummy logits; the
scan indices sorted by descending uncertainty go to an `.npy` ordering file
(the `uncertain_idx_file` that `ExpDiscover`'s `use_first_dataloader` path
reads, `exp.py:5085-5101`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.minkunet import assemble_dummy_logits
from .common import plan_and_gather, voxel_batch_to_device


@torch.no_grad()
def scan_uncertainty(model, batch: dict, cfg) -> torch.Tensor:
    """Mean entropy of the dummy logits over the valid voxels of one scan
    (a `voxel_batch_to_device` dict; `exp.py:2934-2944`), a scalar on the
    device."""
    model.eval()
    plan, feats0, _, _ = plan_and_gather(batch, cfg.voxel_caps)
    probs = torch.softmax(assemble_dummy_logits(model(plan, feats0)).float(), dim=-1)
    ent = -(probs * torch.log(probs + 1e-8)).sum(dim=-1)
    m = plan.levels[0].valid.float()
    return (ent * m).sum() / m.sum().clamp(min=1.0)


def rank_uncertain_scans(model, dataset, cfg, voxel_cap: int, out_file: str | None = None):
    """Score every scan of `dataset` on the model's device; return (indices
    sorted by DESCENDING uncertainty, `exp.py:2966-2981`, the scores) and
    optionally save the ordering file. The scores are read once, at the end."""
    from ..data.collation import collate_batch

    device = next(model.parameters()).device
    scores = [scan_uncertainty(model, voxel_batch_to_device(
        collate_batch([dataset[i]], voxel_cap)["voxel"], device), cfg)
        for i in range(len(dataset))]
    scores = torch.stack(scores).cpu().numpy() if scores else np.zeros(0, np.float32)
    order = np.argsort(-scores, kind="stable").astype(np.int64)
    if out_file:
        np.save(out_file, order)
    return order, scores
