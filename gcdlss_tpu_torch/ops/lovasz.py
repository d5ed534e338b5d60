"""Lovasz-Softmax loss, used by the Cylinder3D head (PyTorch port of
`gcdlss_tpu/ops/lovasz.py`; reference `models/decoder.py:182-326` through
mmdet3d's LovaszLoss).

Fixed shapes: each class's errors are sorted over the whole padded point set,
with invalid rows at error 0 falling to the end (weight 0). The sort is
stable, as `jnp.argsort` is: among equal errors (every masked row) the order,
and so the gradient, is the JAX package's.
"""

from __future__ import annotations

import torch


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension w.r.t. the sorted errors, along the
    last axis."""
    gts = gt_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, dim=-1)
    union = gts + torch.cumsum(1.0 - gt_sorted, dim=-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


def lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor | None = None,
                   classes: str = "present") -> torch.Tensor:
    """probs [N, C] softmax probabilities, labels [N] int (-1 ignored).
    "present": the mean over the classes some valid row carries; otherwise
    over all C."""
    n, c = probs.shape
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=probs.device)
    valid = valid & (labels >= 0)
    vm = valid.to(probs.dtype)
    cls = torch.arange(c, device=probs.device)[:, None]
    fg = ((labels[None, :] == cls) & valid[None, :]).to(probs.dtype)  # [C, N]
    errors = (fg - probs.T).abs() * vm
    order = torch.argsort(-errors, dim=1, stable=True)
    errors_sorted = errors.gather(1, order)
    grad = _lovasz_grad(fg.gather(1, order))
    losses = (errors_sorted * grad).sum(dim=1)
    if classes == "present":
        pm = (fg.sum(dim=1) > 0).to(probs.dtype)
        return (losses * pm).sum() / pm.sum().clamp(min=1.0)
    return losses.mean()
