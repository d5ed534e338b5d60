"""LaserMix on the voxel grid (PyTorch port of the voxel-level part of
`gcdlss_tpu/train/lasermix.py`).

Each (labeled, unlabeled) scan pair is split into `num_areas` pitch bands
between -25 and 3 degrees; the even bands (counted from the top) of the
labeled scan and the odd bands of the unlabeled scan form mixed scan 1, the
complements mixed scan 2. LaserMix only selects points and never moves them,
so the mixed scans share the combined batch's voxel grid:
`lasermix_voxel_groups` assigns every combined level-0 voxel to one mixed
scan by the band parity of the voxel's center.

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
