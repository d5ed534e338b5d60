"""Device-side voxelization: quantize and unique at a fixed capacity
(PyTorch port of `gcdlss_tpu/ops/voxelize.py`).

The counterpart of `ME.utils.sparse_quantize` / `ME.utils.batched_coordinates`
for the in-step LaserMix re-voxelization of the point-mode mixed plan
(reference `modules/exp_merge_mean_teacher.py:2856-2861`). Quantization is
`floor(points / voxel_size)`; each voxel keeps its first point in stable
order as its representative. Every shape is static.
"""

from __future__ import annotations

import numpy as np
import torch

from .coords import SENTINEL_HI, decode_keys, encode_coords, sorted_unique


def sparse_quantize(points: torch.Tensor, batch_idx: torch.Tensor, valid: torch.Tensor,
                    voxel_size: float, capacity: int) -> dict:
    """Quantize a batched point cloud into unique voxels.

    points [P, 3] f32 xyz, batch_idx [P] int scan index, valid [P] bool.
    Returns a dict: `coords` [capacity, 4] int32 (b, x, y, z), 0 on padding;
    `valid` [capacity]; `rep` [capacity] int32 first point of each voxel (P
    on padding); `inverse` [P] int32 voxel row of each point (capacity where
    dropped or invalid); `count` the number of unique voxels before the
    capacity; `keys` the sorted (hi, lo) pair.

    The quotient is a float32 divide by a tensor, as XLA computes it: a
    divide by a Python scalar may become a product with its reciprocal on the
    card, which moves a point on a voxel face one voxel over."""
    step = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    q = torch.floor(points / step).to(torch.int32)
    coords = torch.cat([batch_idx[:, None].to(torch.int32), q], dim=1)
    hi, lo = encode_coords(coords, valid)
    (uh, ul), rep, inverse, count = sorted_unique(hi, lo, capacity)
    vvalid = uh != SENTINEL_HI
    return {
        "coords": torch.where(vvalid[:, None], decode_keys(uh, ul), 0),
        "valid": vvalid,
        "rep": rep,
        "inverse": inverse,
        "count": count,
        "keys": (uh, ul),
    }


def batched_coordinates(coords_list) -> np.ndarray:
    """Prepend the batch index column to a list of [Ni, 3] arrays (numpy)."""
    out = []
    for b, c in enumerate(coords_list):
        bb = np.full((c.shape[0], 1), b, dtype=np.int32)
        out.append(np.hstack([bb, np.asarray(c, dtype=np.int32)]))
    return np.concatenate(out, axis=0)
