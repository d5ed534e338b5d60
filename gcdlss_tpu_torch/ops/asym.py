"""Asymmetric and strided sparse-conv books for the Cylinder3D backbone
(PyTorch port of `gcdlss_tpu/ops/asym.py`).

spconv's `SubMConv3d` with asymmetric kernels ((1,3,3), (3,1,3), (3,1,1),
...) reads subsets of the full 3x3x3 neighbourhood, so one 27-offset map per
level serves every kernel shape: each asymmetric book is a column subset of
it (`offset_subset`).

The strided `SparseConv3d(k=3, s, p=1)` down edge and the
`SparseInverseConv3d(k=3)` up edge get books of their own:
  * down: the coarse sites are unique(floor(fine / stride)) per axis; column
    d of a coarse row holds the fine site at `stride * o + offset_d`;
  * up: column d of a fine row f holds the coarse site (f - offset_d) /
    stride where that division is exact on every strided axis, else -1.
The two list the same (coarse, fine, d) triples from their two sides, so
each is the other's adjoint at the same offset index (`ops.conv.
paired_gather_conv`). Strides are per axis: (2, 2, 2) and (2, 2, 1).
"""

from __future__ import annotations

import numpy as np
import torch

from .conv import gather_conv
from .coords import SENTINEL_HI, decode_keys, encode_coords, sorted_unique
from .join import sorted_join
from .plan import KERNEL_OFFSETS_3


def offset_subset(kernel_shape) -> np.ndarray:
    """Column indices into the 27-offset map for an asymmetric kernel:
    (1, 3, 3) keeps the offsets with dx == 0, and so on."""
    keep = [i for i, off in enumerate(KERNEL_OFFSETS_3)
            if all(k != 1 or d == 0 for d, k in zip(off, kernel_shape))]
    return np.array(keep, np.int32)


def pool_coords(coords: torch.Tensor, valid: torch.Tensor, stride_vec, capacity: int) -> dict:
    """The coarse level: unique(floor(coords / stride)) per axis (an
    arithmetic shift, which floors negative coordinates too)."""
    cols = [coords[:, 0:1]]
    for i, s in enumerate(stride_vec):
        c = coords[:, i + 1:i + 2]
        cols.append(c >> int(np.log2(s)) if s > 1 else c)
    hi, lo = encode_coords(torch.cat(cols, dim=1), valid)
    (uh, ul), _, inverse, count = sorted_unique(hi, lo, capacity)
    vvalid = uh != SENTINEL_HI
    return {
        "coords": torch.where(vvalid[:, None], decode_keys(uh, ul), 0),
        "valid": vvalid,
        "keys": (uh, ul),
        "count": count,
        "parent": inverse,  # fine row -> coarse row
    }


def _join_queries(batch: torch.Tensor, q: torch.Tensor, qvalid: torch.Tensor, keys) -> torch.Tensor:
    """[n, 27] rows of the (batch, q) sites in the sorted level `keys`."""
    n, k = q.shape[:2]
    qc = torch.cat([batch[:, None, None].expand(n, k, 1), q], dim=2).reshape(-1, 4)
    qh, ql = encode_coords(qc, qvalid.reshape(-1))
    return sorted_join(keys[0], keys[1], qh, ql).reshape(n, k)


def _offsets(device) -> torch.Tensor:
    return torch.as_tensor(KERNEL_OFFSETS_3, dtype=torch.int32, device=device)


def strided_down_map(coarse_coords: torch.Tensor, coarse_valid: torch.Tensor, fine_keys,
                     stride_vec) -> torch.Tensor:
    """[Nc, 27] fine rows: column d holds the fine site at stride * o +
    offset_d (the k=3, p=1 window)."""
    sv = torch.as_tensor(np.asarray(stride_vec, np.int32), device=coarse_coords.device)
    q = coarse_coords[:, None, 1:4] * sv + _offsets(coarse_coords.device)[None]
    qv = coarse_valid[:, None].expand(q.shape[:2])
    return _join_queries(coarse_coords[:, 0], q, qv, fine_keys)


def inverse_up_map(fine_coords: torch.Tensor, fine_valid: torch.Tensor, coarse_keys,
                   stride_vec) -> torch.Tensor:
    """[Nf, 27] coarse rows for SparseInverseConv3d(k=3): column d holds the
    coarse site (f - offset_d) / stride where the division is exact, else
    -1. Floor division and remainder, as the JAX package's `//` and `%`:
    f - offset_d is -1 at coordinate 0."""
    fo = fine_coords[:, None, 1:4] - _offsets(fine_coords.device)[None]
    exact = fine_valid[:, None].expand(fo.shape[:2]).clone()
    q = []
    for i, s in enumerate(stride_vec):
        if s > 1:
            exact &= torch.remainder(fo[:, :, i], s) == 0
            q.append(torch.div(fo[:, :, i], s, rounding_mode="floor"))
        else:
            q.append(fo[:, :, i])
    return _join_queries(fine_coords[:, 0], torch.stack(q, dim=2), exact, coarse_keys)


def strided_gather_conv(fine_feats: torch.Tensor, down_map: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """The k=3 strided conv through its [Nc, 27] book (weights [27, Ci, Co]),
    plain, f32 sums."""
    return gather_conv(fine_feats, down_map, weight)
