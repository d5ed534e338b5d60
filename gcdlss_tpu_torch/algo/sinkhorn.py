"""Sinkhorn-Knopp optimal-transport assignment (PyTorch port of
`gcdlss_tpu/algo/sinkhorn.py`).

  * `sinkhorn_knopp`: the SwAV assignment, iterated in log space
    (`utils/sinkhorn_knopp.py:128-167`);
  * `sinkhorn_knopp_weighted`: the prototype marginal softmax(log_w)
    (`SinkhornKnopp_im`, `:6-52`);
  * `balanced_sinkhorn`: the prototype marginal learned by an inner SGD loop
    (`Balanced_sinkhorn`, `:55-79`);
  * `semi_sinkhorn_knopp`: semi-relaxed OT with a KL-constrained prototype
    marginal (`SemiSinkhornKnopp`, `:82-126`).

Masked and fixed-shape: `valid` marks the real rows, which alone enter the
marginals; a masked row comes out as zeros. The JAX package sets masked rows
to -inf, and the row normalization turns them into NaN, which the next
column logsumexp spreads into every valid row whenever any row is masked
(ROADMAP Queue 3). Here a masked row is left out of each column sum instead,
so the valid rows come out as the JAX functions give them for the valid rows
alone, and no NaN is made, in the values or in the gradients.
"""

from __future__ import annotations

import math

import torch


def _normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


def _cosine_logits(features: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Cosine of each row of `features` [N, C] with each column of `head` [C, K]."""
    c = head / torch.linalg.vector_norm(head, dim=0, keepdim=True).clamp(min=1e-8)
    return _normalize(features) @ c


def _column_lse(logq: torch.Tensor, vmask: torch.Tensor) -> torch.Tensor:
    """logsumexp over the valid rows of each column; 0 where none is valid
    (every row is then masked, and zeroed at the end)."""
    lse = torch.logsumexp(logq.masked_fill(~vmask, -math.inf), dim=0, keepdim=True)
    return torch.where(torch.isfinite(lse), lse, 0.0)


def _sinkhorn_iters(logq, vmask, b, num_iters: int, logw=None, k: int = 1):
    """`num_iters` rounds of: normalize each prototype over the samples (to
    the marginal exp(logw), or 1/k), then each sample over the prototypes
    (to 1/b). Returns Q * b, zero on masked rows."""
    for _ in range(num_iters):
        logq = logq - _column_lse(logq, vmask)
        logq = logq - math.log(k) if logw is None else logq + logw[None, :]
        logq = logq - torch.logsumexp(logq, dim=1, keepdim=True)
        logq = logq - torch.log(b)
    return torch.where(vmask, torch.exp(logq) * b, 0.0)


def _count(valid: torch.Tensor) -> torch.Tensor:
    return valid.to(torch.float32).sum().clamp(min=1.0)


def sinkhorn_knopp(features, head, valid=None, queue=None, queue_valid=None,
                   num_iters: int = 3, epsilon: float = 0.05) -> torch.Tensor:
    """SwAV assignment Q [N, K] of `features` [N, C] to the prototype columns
    of `head` [C, K]; rows of masked features are zeros. Queue rows take
    part in the marginals but are not returned (the reference's behaviour)."""
    n = features.shape[0]
    if queue is not None:
        features = torch.cat([features, queue])
        valid = torch.cat([valid, queue_valid]) if valid is not None else None
    if valid is None:
        valid = torch.ones(features.shape[0], dtype=torch.bool, device=features.device)
    logits = _cosine_logits(features, head) / epsilon
    q = _sinkhorn_iters(logits, valid[:, None], _count(valid), num_iters, k=head.shape[1])
    return q[:n]


def sinkhorn_knopp_weighted(features, head, log_w, valid=None, num_iters: int = 3,
                            epsilon: float = 0.05) -> torch.Tensor:
    """Sinkhorn with the non-uniform prototype marginal softmax(log_w)."""
    if valid is None:
        valid = torch.ones(features.shape[0], dtype=torch.bool, device=features.device)
    logits = _cosine_logits(features, head) / epsilon
    logw = torch.log_softmax(log_w.reshape(-1), dim=0)
    return _sinkhorn_iters(logits, valid[:, None], _count(valid), num_iters, logw=logw)


def balanced_sinkhorn(features, head, valid=None, num_iters: int = 3, epsilon: float = 0.05,
                      lr_w: float = 0.1, momentum: float = 0.99, num_outer_iters: int = 10,
                      gamma: float = 5.0):
    """Balanced Sinkhorn: the prototype marginal softmax(w) learned by SGD
    (momentum, the gradient clipped to norm 1) on
    -E[<Q(w), cosine logits>] + gamma * KL(uniform || softmax(w)) / K,
    the gradient taken through the whole log-space iteration.

    Returns (q, marginal): the Q of the last call before the final update of
    w (as the reference returns it) and the final softmax(w)."""
    n, k = features.shape[0], head.shape[1]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=features.device)
    preds = _cosine_logits(features, head).detach()  # the reward uses these, not / epsilon
    vmask = valid[:, None]
    b = _count(valid)
    nmask = vmask.to(torch.float32)
    t = 1.0 / k

    w = torch.full((k,), t, dtype=torch.float32, device=features.device)
    vel = torch.zeros_like(w)
    q = torch.zeros(n, k, dtype=torch.float32, device=features.device)
    for _ in range(num_outer_iters):
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            logw = torch.log_softmax(w, dim=0)
            q = _sinkhorn_iters(preds / epsilon, vmask, b, num_iters, logw=logw) * nmask
            reward = -(q * preds * nmask).sum() / b
            reg = (t * (math.log(t) - logw)).sum() / k
            (g,) = torch.autograd.grad(reward + gamma * reg, w)
        q, w = q.detach(), w.detach()
        g = g * torch.clamp(1.0 / torch.linalg.vector_norm(g).clamp(min=1e-6), max=1.0)
        vel = momentum * vel + g  # torch SGD: buf = mu * buf + grad; p -= lr * buf
        w = w - lr_w * vel
    return q, torch.softmax(w, dim=0)


def semi_sinkhorn_knopp(logits, valid=None, epsilon: float = 0.1, gamma: float = 1.0,
                        num_iters: int = 100):
    """Semi-relaxed OT: an equality constraint on the samples, a KL one on
    the prototypes. logits [N, K] raw scores. Returns (plan [N, K], loss,
    kl_reg)."""
    n, k = logits.shape
    dev = logits.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    vm = valid[:, None].to(torch.float32)
    p = -torch.log_softmax(logits / 0.1, dim=1)
    q = torch.exp(-p / epsilon) * vm
    nvalid = _count(valid)
    pa = vm[:, 0] / nvalid  # the sample marginal
    pb = torch.ones(k, dtype=torch.float32, device=dev) / k
    fi = gamma / (gamma + epsilon)
    b = torch.ones(k, dtype=torch.float32, device=dev) / k
    for _ in range(num_iters):
        a = pa / (q @ b).clamp(min=1e-30)
        b = torch.pow(pb / (q.T @ a).clamp(min=1e-30), fi)
    a = pa / (q @ b).clamp(min=1e-30)
    plan = nvalid * a[:, None] * q * b[None, :]
    loss = ((plan * p).sum(dim=1) * valid).sum() / nvalid
    w = (plan * vm).sum(dim=0) / nvalid
    kl = (w * (torch.log(w + 1e-7) - torch.log(pb))).sum()
    return plan, loss, kl
