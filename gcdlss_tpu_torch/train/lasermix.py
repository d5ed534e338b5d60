"""LaserMix: pitch-band scan mixing inside the step (PyTorch port of
`gcdlss_tpu/train/lasermix.py`).

Each (labeled, unlabeled) scan pair is split into `num_areas` pitch bands
between -25 and 3 degrees; the even bands (counted from the top) of the
labeled scan and the odd bands of the unlabeled scan form mixed scan 1, the
complements mixed scan 2. Two forms:

  * on the points (`lasermix_pair`, `lasermix_batch`): each mixed scan keeps
    the union [2P] of its pair's points with a membership mask, to be
    re-quantized in the step (the point-mode mixed plan, the reference's
    protocol);
  * on the voxel grid (`lasermix_voxel_groups`): LaserMix only selects
    points and never moves them, so the mixed scans share the combined
    batch's voxel grid, and every combined level-0 voxel goes to one mixed
    scan by the band parity of its center.

`band_parity` truncates an f32 pitch ratio: a voxel center within an ulp of a
band edge can fall on the other side of it than in the JAX package, whose
arctan2 may round differently.
"""

from __future__ import annotations

import math

import torch

PITCH_ANGLES = (-25.0, 3.0)
NUM_AREAS_CHOICES = (3, 4, 5, 6)


def pitch_of(xyz: torch.Tensor) -> torch.Tensor:
    rho = torch.sqrt(xyz[..., 0] ** 2 + xyz[..., 1] ** 2)
    return torch.atan2(xyz[..., 2], rho)


def band_parity(xyz: torch.Tensor, num_areas: torch.Tensor) -> torch.Tensor:
    """Band parity per point (0 = even band from the top); `num_areas` is an
    integer tensor (a scalar on the points' device)."""
    down = PITCH_ANGLES[0] / 180.0 * math.pi
    up = PITCH_ANGLES[1] / 180.0 * math.pi
    p = pitch_of(xyz).clamp(down + 1e-5, up - 1e-5)
    step = (up - down) / num_areas.to(torch.float32)
    band = ((up - p) / step).to(torch.int32)
    band = torch.minimum(band.clamp(min=0), num_areas.to(torch.int32) - 1)
    return band % 2


def lasermix_pair(sup: dict, unsup: dict, num_areas: torch.Tensor) -> dict:
    """Mix one labeled / unlabeled scan pair.

    sup / unsup: dicts of `xyz` [P, 3], `feats` [P, C], `labels` [P], `valid`
    [P] (the unsup labels are the teacher's pseudo labels, -1 where it is
    unsure). Returns the union [2P] `xyz`, `feats`, `labels` and the
    membership masks `mix1` / `mix2`."""
    in1_s = (band_parity(sup["xyz"], num_areas) == 0) & sup["valid"]
    in1_u = (band_parity(unsup["xyz"], num_areas) == 1) & unsup["valid"]
    valid = torch.cat([sup["valid"], unsup["valid"]])
    mix1 = torch.cat([in1_s, in1_u])
    return {"xyz": torch.cat([sup["xyz"], unsup["xyz"]]),
            "feats": torch.cat([sup["feats"], unsup["feats"]]),
            "labels": torch.cat([sup["labels"], unsup["labels"]]),
            "mix1": mix1, "mix2": valid & ~mix1}


def lasermix_batch(sup_points: dict, unsup_points: dict, pseudo_labels: torch.Tensor,
                   num_areas: torch.Tensor):
    """Mix S scan pairs into 2S mixed scans: mix1 of every pair, then mix2.

    sup_points / unsup_points: dicts of [S, P, ...] tensors (`xyz`, `feats`,
    `mapped_labels`, `valid`); pseudo_labels [S, P] for the unsup scans.
    Returns (xyz [2S, 2P, 3], feats [2S, 2P, C], labels [2S, 2P],
    valid [2S, 2P])."""
    mixed = [lasermix_pair(
        {"xyz": sup_points["xyz"][i], "feats": sup_points["feats"][i],
         "labels": sup_points["mapped_labels"][i], "valid": sup_points["valid"][i]},
        {"xyz": unsup_points["xyz"][i], "feats": unsup_points["feats"][i],
         "labels": pseudo_labels[i], "valid": unsup_points["valid"][i]}, num_areas)
        for i in range(sup_points["xyz"].shape[0])]
    xyz = torch.stack([m["xyz"] for m in mixed] * 2)
    feats = torch.stack([m["feats"] for m in mixed] * 2)
    labels = torch.stack([m["labels"] for m in mixed] * 2)
    valid = torch.stack([m["mix1"] for m in mixed] + [m["mix2"] for m in mixed])
    return xyz, feats, labels, valid


def lasermix_voxel_groups(coords: torch.Tensor, is_sup: torch.Tensor, num_sup: int,
                          num_areas: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Mixed-scan id per combined level-0 voxel row.

    coords: [cap0, 4] (b, x, y, z); sup scans are b in [0, num_sup), unsup
    scans b in [num_sup, 2 num_sup). Mixed scan i collects the even sup bands
    and odd unsup bands of pair i, mixed scan num_sup + i the complements."""
    center = (coords[:, 1:4].to(torch.float32) + 0.5) * voxel_size
    par = band_parity(center, num_areas)
    b = coords[:, 0]
    pair = torch.where(is_sup, b, b - num_sup)
    in1 = torch.where(is_sup, par == 0, par == 1)
    return torch.where(in1, pair, num_sup + pair).to(torch.int32)
