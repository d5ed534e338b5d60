"""Feature-mixing augmentations (PyTorch port of `gcdlss_tpu/train/feature_mixing.py`).

Rebuild of `mix_features` / `mix_unsup_features` / `mix_unsup_centroid`
(`modules/exp_merge_mean_teacher.py:2639-2734`) and `mix_centroid_sup`
(`modules/exp.py:1494-1517`): random permutations of the voxel rows pair (or
triple) features, convex-combined with a Beta(b, b) ratio or averaged; pair
mixes carry soft (two-hot) targets, the others the unknown slot. Masked and
fixed-shape: rows whose sources fail the test carry zero features, zero
targets (or label -1) and `ok` False.

The draws come from an explicit `torch.Generator` on the features' device:
the permutations first, then the ratio. Each function also takes its draws
(`perms=`, `ratio=`), so that a test can feed it another package's.
"""

from __future__ import annotations

import math

import torch


def draw_perms(generator: torch.Generator, n: int, count: int, device) -> tuple:
    return tuple(torch.randperm(n, generator=generator, device=device) for _ in range(count))


def _gamma(shape: float, generator: torch.Generator, device) -> torch.Tensor:
    """One Gamma(shape, 1) draw: Marsaglia and Tsang's rejection method
    (shape < 1 through Gamma(shape + 1) * U^(1 / shape)). Each trial reads
    the device."""
    if shape < 1.0:
        u = torch.rand((), generator=generator, device=device)
        return _gamma(shape + 1.0, generator, device) * u ** (1.0 / shape)
    d = shape - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = torch.randn((), generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        u = torch.rand((), generator=generator, device=device)
        if v > 0 and torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v):
            return d * v


def beta_draw(a: float, b: float, generator: torch.Generator, device) -> torch.Tensor:
    """One Beta(a, b) draw from `generator`, as an f32 scalar on `device`.

    Beta(1/2, 1/2), the only law the recipes use, is the arcsine law:
    sin^2(pi u / 2) with u uniform, one draw, no read of the device. Any other
    (a, b) takes the ratio of two Gamma draws."""
    if a == b == 0.5:
        u = torch.rand((), generator=generator, device=device)
        return torch.sin(0.5 * math.pi * u) ** 2
    x, y = _gamma(a, generator, device), _gamma(b, generator, device)
    return (x / (x + y)).float()


def _take_perms(generator, perms, n: int, count: int, device) -> tuple:
    if perms is None:
        return draw_perms(generator, n, count, device)
    return tuple(torch.as_tensor(p, device=device).long() for p in perms)


def mix_features(generator, feats, labels, valid, num_classes: int,
                 beta_coeff: float = 0.5, mixing_ratio: float | None = None,
                 perms=None, ratio=None):
    """Returns (mix_feats [N, C], mix_probs [N, num_classes], mix_valid [N]).

    The ratio is `mixing_ratio` when given, else `ratio`, else a
    Beta(beta_coeff, beta_coeff) draw."""
    n = feats.shape[0]
    p1, p2 = _take_perms(generator, perms, n, 2, feats.device)
    l1, l2 = labels[p1], labels[p2]
    ok = (l1 != l2) & valid[p1] & valid[p2] & (l1 >= 0) & (l2 >= 0)
    if mixing_ratio is not None:
        r = mixing_ratio
    elif ratio is not None:
        r = ratio
    else:
        r = beta_draw(beta_coeff, beta_coeff, generator, feats.device)
    mix = (r * feats[p1] + (1.0 - r) * feats[p2]).detach() * ok[:, None]
    one_hot = torch.nn.functional.one_hot
    probs = (r * one_hot(l1.clamp(0, num_classes - 1).long(), num_classes)
             + (1.0 - r) * one_hot(l2.clamp(0, num_classes - 1).long(), num_classes))
    probs = probs / probs.sum(dim=-1, keepdim=True).clamp(min=1e-12)
    return mix, probs * ok[:, None], ok


def mix_centroid_sup(generator, feats, labels, valid, unknown_label: int, perms=None):
    """Average labeled feature triples with pairwise-distinct labels; the
    target is the unknown slot. Returns (mix [N, C], mix_labels [N] int32, ok [N])."""
    n = feats.shape[0]
    p1, p2, p3 = _take_perms(generator, perms, n, 3, feats.device)
    l1, l2, l3 = labels[p1], labels[p2], labels[p3]
    ok = (valid[p1] & valid[p2] & valid[p3]
          & (l1 >= 0) & (l2 >= 0) & (l3 >= 0)
          & (l1 != l2) & (l2 != l3) & (l1 != l3))
    mix = ((feats[p1] + feats[p2] + feats[p3]) / 3.0).detach() * ok[:, None]
    return mix, _unknown_or_ignore(ok, unknown_label), ok


def mix_unsup_features(generator, feats, valid, unknown_label: int, beta_coeff: float = 0.5,
                       perms=None, ratio=None):
    """Mix random unsup feature pairs at a Beta(beta_coeff, beta_coeff) ratio
    (or `ratio`); the target is the unknown slot."""
    n = feats.shape[0]
    p1, p2 = _take_perms(generator, perms, n, 2, feats.device)
    ok = valid[p1] & valid[p2]
    r = beta_draw(beta_coeff, beta_coeff, generator, feats.device) if ratio is None else ratio
    mix = (r * feats[p1] + (1.0 - r) * feats[p2]).detach() * ok[:, None]
    return mix, _unknown_or_ignore(ok, unknown_label), ok


def mix_unsup_centroid(generator, feats, valid, unknown_label: int, perms=None):
    """Average random feature triples; the target is the unknown slot."""
    n = feats.shape[0]
    p1, p2, p3 = _take_perms(generator, perms, n, 3, feats.device)
    ok = valid[p1] & valid[p2] & valid[p3]
    mix = ((feats[p1] + feats[p2] + feats[p3]) / 3.0).detach() * ok[:, None]
    return mix, _unknown_or_ignore(ok, unknown_label), ok


def _unknown_or_ignore(ok: torch.Tensor, unknown_label: int) -> torch.Tensor:
    return torch.where(ok, unknown_label, -1).to(torch.int32)
