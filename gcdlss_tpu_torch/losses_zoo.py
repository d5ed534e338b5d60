"""Auxiliary loss zoo of the reference's ablation experiments (PyTorch port
of `gcdlss_tpu/losses_zoo.py`, reference `utils/loss.py`).

HybridDistanceCrossEntropyLoss, AttractiveLoss, RegularizationTerm, AdvLoss,
pairwise BCE, SupConLoss (+ the auxiliary and metric variants) and
DistillLoss (DINO-style, teacher temperature warmed up). Every function
computes in f32 and takes explicit masks instead of dynamic shapes. Kept
from the JAX package: the view-major stacking of [N, V, C] features, the
stop-gradient on the stability max and on the teacher's softmax, and the
"reverse" metrics that subtract the un-negated max.
"""

from __future__ import annotations

import torch

from .losses import cross_entropy


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


def _view_major(features: torch.Tensor) -> torch.Tensor:
    """[N, V, C] -> [V N, C]: view 0's rows, then view 1's, ... (the
    reference's `torch.cat(torch.unbind(features, dim=1))`)."""
    n, v, c = features.shape
    return features.float().transpose(0, 1).reshape(n * v, c)


def hybrid_distance_cross_entropy(features, prototypes, labels, valid=None, normalized=True):
    """CE over cosine (or negative squared euclidean) feature-prototype
    similarities."""
    features, prototypes = features.float(), prototypes.float()
    if normalized:
        logits = _normalize(features) @ _normalize(prototypes).T
    else:
        logits = -(features[:, None, :] - prototypes[None, :, :]).square().sum(dim=-1)
    return cross_entropy(logits, labels, valid)


def attractive_loss(features, prototypes, labels, valid=None):
    """Pull features towards their class prototype (mean squared distance)."""
    safe = labels.clamp(0, prototypes.shape[0] - 1).long()
    d = (features.float() - prototypes.float()[safe]).square().sum(dim=-1)
    mask = labels >= 0
    if valid is not None:
        mask = mask & valid
    m = mask.float()
    return (d * m).sum() / m.sum().clamp(min=1.0)


def prototype_regularization(prototypes):
    """Penalize prototype similarity (the off-diagonal cosines)."""
    pn = _normalize(prototypes.float())
    sim = pn @ pn.T
    k = prototypes.shape[0]
    off = sim - torch.eye(k, device=sim.device) * sim
    return off.abs().sum() / max(k * (k - 1), 1)


def adv_loss(synthetic_features, prototypes, epsilon=1e-6):
    """Push synthetic (unseen-class) features away from all seen prototypes."""
    sim = _normalize(synthetic_features.float()) @ _normalize(prototypes.float()).T
    p = torch.softmax(sim, dim=-1)
    return -(p * torch.log(p + epsilon)).sum(dim=-1).mean()


def pairwise_bce(prob1, prob2, simi):
    """Pairwise similarity BCE: simi in {+1, -1} per pair."""
    p = (prob1.float() * prob2.float()).sum(dim=-1)
    signed = simi * (p - 1.0) / 2.0 + (1.0 + p) / 2.0
    return -torch.log(signed.clamp(1e-7, 1.0 - 1e-7)).mean()


def _label_mask(n: int, labels, mask, device) -> torch.Tensor:
    if mask is not None:
        return mask.float()
    if labels is None:
        return torch.eye(n, device=device)
    return (labels[:, None] == labels[None, :]).float()


def supcon_loss(features, labels=None, mask=None, valid=None, temperature=0.07,
                base_temperature=0.07):
    """Supervised contrastive loss (Khosla et al.) over [N, V, C] features,
    L2-normalised per view. Positives share a label (`labels`), or are
    marked by `mask` [N, N]."""
    n, v, _ = features.shape
    dev = features.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    mask = _label_mask(n, labels, mask, dev)
    feats = _view_major(features)
    sim = feats @ feats.T / temperature
    sim = sim - sim.max(dim=1, keepdim=True).values.detach()
    vvalid = valid.repeat(v).float()
    logits_mask = (1.0 - torch.eye(n * v, device=dev)) * vvalid[None, :]
    big_mask = mask.repeat(v, v) * logits_mask
    exp = torch.exp(sim) * logits_mask
    log_prob = sim - torch.log(exp.sum(dim=1, keepdim=True).clamp(min=1e-12))
    pos_cnt = big_mask.sum(dim=1).clamp(min=1.0)
    loss = -(temperature / base_temperature) * (big_mask * log_prob).sum(dim=1) / pos_cnt
    return (loss * vvalid).sum() / vvalid.sum().clamp(min=1.0)


def supcon_loss_with_auxiliary(features, labels, aux_features, valid=None, aux_valid=None,
                               temperature=0.07, base_temperature=0.07):
    """SupCon with auxiliary pure-negative features (`SupConLossWithAuxiliary`,
    `utils/loss.py:261-352`): the aux rows [M, C] join the contrast set but
    are never anchors nor positives."""
    n, v, _ = features.shape
    m = aux_features.shape[0]
    dev = features.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    if aux_valid is None:
        aux_valid = torch.ones(m, dtype=torch.bool, device=dev)
    mask = (labels[:, None] == labels[None, :]).float()
    anchors = _view_major(features)
    contrast = torch.cat([anchors, aux_features.float()])
    sim = anchors @ contrast.T / temperature
    sim = sim - sim.max(dim=1, keepdim=True).values.detach()
    big_mask = torch.cat([mask.repeat(v, v), torch.zeros(n * v, m, device=dev)], dim=1)
    vvalid = torch.cat([valid.repeat(v), aux_valid]).float()
    logits_mask = torch.cat([1.0 - torch.eye(n * v, device=dev),
                             torch.ones(n * v, m, device=dev)], dim=1) * vvalid[None, :]
    big_mask = big_mask * logits_mask
    exp = torch.exp(sim) * logits_mask
    log_prob = sim - torch.log(exp.sum(dim=1, keepdim=True).clamp(min=1e-12))
    pos_cnt = big_mask.sum(dim=1).clamp(min=1.0)
    loss = -(temperature / base_temperature) * (big_mask * log_prob).sum(dim=1) / pos_cnt
    am = valid.repeat(v).float()
    return (loss * am).sum() / am.sum().clamp(min=1.0)


METRICS = ("dot", "reverse_dot", "sign_l2", "reverse_sign_l2")


def metric_supcon_loss(features, labels=None, mask=None, ignore=None, valid=None,
                       metric: str = "dot", temperature=0.07, base_temperature=0.07,
                       reduction: bool = True):
    """SupCon under another similarity (`MetricSupConLoss`,
    `utils/loss.py:354-476`): `metric` one of METRICS. The stability max is
    taken on the raw similarities and the "reverse" metrics negate them but
    still subtract that (un-negated) max, as the reference does; "sign_l2"
    is the negative mean squared distance of tanh-squashed features.
    `ignore` [N] restricts each anchor's denominator to the rows sharing its
    id; `reduction=False` returns the per-anchor losses [V, N]."""
    if metric not in METRICS:
        raise NotImplementedError(metric)
    n, v, _ = features.shape
    dev = features.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    mask = _label_mask(n, labels, mask, dev)
    feats = _view_major(features)
    if metric in ("dot", "reverse_dot"):
        raw = feats @ feats.T / temperature
    else:
        t = torch.tanh(feats)
        raw = -(t[:, None, :] - t[None, :, :]).square().mean(dim=-1) / temperature
    mx = raw.max(dim=1, keepdim=True).values.detach()
    sim = (-raw if metric.startswith("reverse") else raw) - mx
    vvalid = valid.repeat(v).float()
    logits_mask = (1.0 - torch.eye(n * v, device=dev)) * vvalid[None, :]
    big_mask = mask.repeat(v, v) * logits_mask
    denom_mask = logits_mask
    if ignore is not None:
        ig = ignore.repeat(v)
        denom_mask = denom_mask * (ig[:, None] == ig[None, :]).float()
    exp = torch.exp(sim) * denom_mask
    log_prob = sim - torch.log(exp.sum(dim=1, keepdim=True).clamp(min=1e-12))
    pos_cnt = big_mask.sum(dim=1).clamp(min=1.0)
    loss = -(temperature / base_temperature) * (big_mask * log_prob).sum(dim=1) / pos_cnt
    if not reduction:
        return loss.reshape(v, n)
    return (loss * vvalid).sum() / vvalid.sum().clamp(min=1.0)


def distill_loss(student_out, teacher_out, epoch, warmup_teacher_temp_epochs: int,
                 nepochs: int, ncrops: int = 2, warmup_teacher_temp: float = 0.07,
                 teacher_temp: float = 0.04, student_temp: float = 0.1):
    """DINO-style distillation; the teacher temperature moves linearly from
    `warmup_teacher_temp` to `teacher_temp` over the warm-up epochs and stays
    there (the fraction clipped to [0, 1]). Each crop of the teacher is held
    against every other crop of the student."""
    frac = min(max(float(epoch) / max(warmup_teacher_temp_epochs, 1), 0.0), 1.0)
    t_temp = warmup_teacher_temp + frac * (teacher_temp - warmup_teacher_temp)
    s = student_out.float() / student_temp
    t = torch.softmax(teacher_out.float() / t_temp, dim=-1).detach()
    total, nterms = 0.0, 0
    for iq, q in enumerate(t.chunk(ncrops)):
        for iv, p in enumerate(s.chunk(ncrops)):
            if iv == iq:
                continue
            total = total + (-q * torch.log_softmax(p, dim=-1)).sum(dim=-1).mean()
            nterms += 1
    return total / max(nterms, 1)
