"""Dynamic voxelization and scatter pooling (PyTorch port of
`gcdlss_tpu/ops/scatter.py`).

The counterparts of mmcv's `dynamic_voxelize`, `hard_voxelize` and
`DynamicScatter` and of torch_scatter's `scatter_mean` over fixed-capacity
buffers: segment reductions over the voxel ids of `coords.sorted_unique`.

The range and the voxel size are made float32 tensors before any arithmetic,
as the JAX package (64-bit types off) rounds them: an f32 tensor op with a
float64 one would promote to float64 here, and a point near a bin edge would
land in the other bin.
"""

from __future__ import annotations

import torch

from .coords import SENTINEL_HI, decode_keys, encode_coords, sorted_unique


def _f32(values, device) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.float32, device=device)


def dynamic_voxelize(points: torch.Tensor, batch_idx: torch.Tensor, valid: torch.Tensor,
                     point_cloud_range, voxel_size):
    """Per-point voxel coords (no pooling): floor((p - range_min) / voxel_size);
    points outside the range are invalid (mmcv's dynamic mode). Returns
    (coords [P, 4] int32, in_range [P] bool)."""
    lo = _f32(point_cloud_range[:3], points.device)
    hi = _f32(point_cloud_range[3:], points.device)
    vs = _f32(voxel_size, points.device)
    grid = torch.floor((hi - lo) / vs).to(torch.int32)
    c = torch.floor((points - lo) / vs).to(torch.int32)
    in_range = ((c >= 0) & (c < grid)).all(dim=-1) & valid
    return torch.cat([batch_idx[:, None].to(torch.int32), c], dim=1), in_range


def cylindrical_coords(points: torch.Tensor) -> torch.Tensor:
    """(x, y, z) -> (rho, phi, z), the 'cylindrical' voxelizer mode."""
    rho = torch.sqrt(points[..., 0] ** 2 + points[..., 1] ** 2)
    phi = torch.atan2(points[..., 1], points[..., 0])
    return torch.stack([rho, phi, points[..., 2]], dim=-1)


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum of x's rows per segment id in [0, num_segments)."""
    out = torch.zeros((num_segments,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add(0, seg.long(), x)


def dynamic_scatter(feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                    capacity: int, mode: str = "max") -> dict:
    """Pool point features into their unique voxels (DynamicScatter).

    Returns a dict: voxel `coords` [capacity, 4] (0 on padding), `valid`,
    `count` (unique voxels before the capacity), pooled `feats` [capacity,
    C], the point -> voxel row `inverse` (capacity where dropped) and `rep`.
    "max" takes each voxel's largest value per channel (an empty voxel
    gives 0); its gradient splits evenly among the points that tie for the
    maximum, as `jax.ops.segment_max`'s does. "mean" averages."""
    hi, lo = encode_coords(coords, valid)
    (uh, ul), rep, inverse, count = sorted_unique(hi, lo, capacity)
    seg = torch.where(valid, inverse.clamp(max=capacity), capacity).long()
    c = feats.shape[-1]
    if mode == "max":
        src = torch.where(valid[:, None], feats, float("-inf"))
        init = torch.full((capacity + 1, c), float("-inf"), dtype=feats.dtype,
                          device=feats.device)
        pooled = init.scatter_reduce(0, seg[:, None].expand(-1, c), src, "amax",
                                     include_self=False)[:capacity]
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
    elif mode == "mean":
        s = _segment_sum(feats * valid[:, None], seg, capacity + 1)[:capacity]
        n = _segment_sum(valid.to(feats.dtype), seg, capacity + 1)[:capacity]
        pooled = s / n[:, None].clamp(min=1.0)
    else:
        raise ValueError(mode)
    vvalid = uh != SENTINEL_HI
    return {
        "feats": pooled * vvalid[:, None],
        "coords": torch.where(vvalid[:, None], decode_keys(uh, ul), 0),
        "valid": vvalid,
        "count": count,
        "inverse": inverse,
        "rep": rep,
    }


def hard_voxelize(points: torch.Tensor, feats: torch.Tensor, batch_idx: torch.Tensor,
                  valid: torch.Tensor, point_cloud_range, voxel_size, max_voxels: int,
                  max_points: int) -> dict:
    """mmcv's 'hard' voxelization: per-voxel buffers of `max_points` points.

    Returns `voxels` [max_voxels, max_points, C] (zero-padded), `num_points`
    [max_voxels], `coords` [max_voxels, 4], `valid` and `count`. A voxel keeps
    its first `max_points` points in input order; voxels past `max_voxels`
    are dropped."""
    coords, in_range = dynamic_voxelize(points, batch_idx, valid, point_cloud_range,
                                        voxel_size)
    hi, lo = encode_coords(coords, in_range)
    (uh, ul), _, inverse, count = sorted_unique(hi, lo, max_voxels)
    seg = torch.where(in_range, inverse.clamp(max=max_voxels), max_voxels)
    # each point's slot in its voxel: its rank among the voxel's points
    n = points.shape[0]
    seg_sorted, order = torch.sort(seg, stable=True)
    pos = torch.arange(n, device=points.device)
    first = torch.ones(n, dtype=torch.bool, device=points.device)
    first[1:] = seg_sorted[1:] != seg_sorted[:-1]
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    ok = in_range & (rank < max_points) & (seg < max_voxels)
    c = feats.shape[-1]
    # rows that do not fit write one slot past the end, which is dropped
    flat = torch.where(ok, seg * max_points + rank, max_voxels * max_points)
    voxels = torch.zeros((max_voxels * max_points + 1, c), dtype=feats.dtype,
                         device=feats.device)
    voxels[flat] = torch.where(ok[:, None], feats, 0.0)
    num = _segment_sum(ok.to(torch.int32), seg, max_voxels + 1)[:max_voxels]
    vvalid = uh != SENTINEL_HI
    return {
        "voxels": voxels[:-1].reshape(max_voxels, max_points, c),
        "num_points": num,
        "coords": torch.where(vvalid[:, None], decode_keys(uh, ul), 0),
        "valid": vvalid,
        "count": count,
    }


def scatter_mean(feats: torch.Tensor, index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """torch_scatter's `scatter_mean` as `jax.ops.segment_sum` computes it:
    a row whose index lies outside [0, num_segments) is dropped."""
    keep = (index >= 0) & (index < num_segments)
    idx = torch.where(keep, index, num_segments)
    s = _segment_sum(feats * keep[:, None].to(feats.dtype), idx, num_segments + 1)
    n = _segment_sum(keep.to(feats.dtype), idx, num_segments + 1)
    return (s / n[:, None].clamp(min=1.0))[:num_segments]
