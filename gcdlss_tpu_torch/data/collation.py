"""Collation: list of ScanSamples -> fixed-capacity padded device batches.

Replaces `utils/collation.py` (`collation_fn_restricted_dataset`,
`collation_fn_lasermix_dataset`): instead of ragged concatenation, scans are
packed into static-shape buffers (fixed capacities, as in the JAX package).
Per-scan voxels keep their host sort order and scans are concatenated in batch
order, so the combined array is already globally sorted by (batch, x, y, z):
the device plan takes it as presorted (`build_unet_plan(presorted=True)`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class VoxelBatchNp(NamedTuple):
    coords: np.ndarray  # [cap, 4] int32 (b,x,y,z)
    feats: np.ndarray  # [cap, C] float32
    labels: np.ndarray  # [cap] int32 train-space labels (-1 pad)
    mapped_labels: np.ndarray  # [cap] int32 compressed labels (-1 pad)
    valid: np.ndarray  # [cap] bool
    scan_ids: np.ndarray  # [B] int32
    num_voxels: np.ndarray  # [B] int32 per-scan voxel counts (pre-truncation)
    # original-scan point index of each voxel's representative (-1 pad):
    # the cross-view identity the reference's SwaV intersection uses
    # (`modules/exp.py:4997-5000` torch.isin over selected indices)
    point_ids: np.ndarray = None


class PointBatchNp(NamedTuple):
    xyz: np.ndarray  # [B, P, 3] float32
    feats: np.ndarray  # [B, P, C]
    labels: np.ndarray  # [B, P] int32 (train-space; -1 pad)
    mapped_labels: np.ndarray  # [B, P]
    valid: np.ndarray  # [B, P] bool
    voxel_row: np.ndarray  # [B, P] int32 point -> global voxel row (cap pad)


def collate_voxels(samples, cap: int, feat_dim: int = 1) -> VoxelBatchNp:
    b = len(samples)
    coords = np.zeros((cap, 4), np.int32)
    feats = np.zeros((cap, feat_dim), np.float32)
    labels = np.full(cap, -1, np.int32)
    mapped = np.full(cap, -1, np.int32)
    valid = np.zeros(cap, bool)
    counts = np.zeros(b, np.int32)
    pids = np.full(cap, -1, np.int32)
    off = 0
    for i, s in enumerate(samples):
        m = s.voxel_coords.shape[0]
        counts[i] = m
        take = min(m, cap - off)
        if take > 0:
            coords[off : off + take, 0] = i
            coords[off : off + take, 1:] = s.voxel_coords[:take]
            feats[off : off + take] = s.voxel_features[:take]
            labels[off : off + take] = s.voxel_labels[:take]
            mapped[off : off + take] = s.voxel_mapped_labels[:take]
            valid[off : off + take] = True
            pids[off : off + take] = s.selected_idx[:take].astype(np.int32)
        off += take
    return VoxelBatchNp(
        coords, feats, labels, mapped, valid,
        np.array([s.scan_idx for s in samples], np.int32), counts, pids,
    )


def collate_points(samples, point_cap: int, voxel_cap: int, feat_dim: int = 1) -> PointBatchNp:
    b = len(samples)
    xyz = np.zeros((b, point_cap, 3), np.float32)
    feats = np.zeros((b, point_cap, feat_dim), np.float32)
    labels = np.full((b, point_cap), -1, np.int32)
    mapped = np.full((b, point_cap), -1, np.int32)
    valid = np.zeros((b, point_cap), bool)
    vrow = np.full((b, point_cap), voxel_cap, np.int32)
    # per-scan voxel offsets in the collated voxel buffer
    offs = np.zeros(b, np.int64)
    off = 0
    for i, s in enumerate(samples):
        offs[i] = off
        off += min(s.voxel_coords.shape[0], max(0, voxel_cap - off))
    off = 0
    for i, s in enumerate(samples):
        n = min(s.points.shape[0], point_cap)
        m = min(s.voxel_coords.shape[0], max(0, voxel_cap - off))
        xyz[i, :n] = s.points[:n]
        feats[i, :n] = s.features[:n]
        labels[i, :n] = s.labels[:n]
        mapped[i, :n] = s.mapped_labels[:n]
        valid[i, :n] = True
        inv = s.inverse_map[:n]
        in_range = inv < m
        vrow[i, :n] = np.where(in_range, off + inv, voxel_cap)
        off += m
    return PointBatchNp(xyz, feats, labels, mapped, valid, vrow)


def collate_batch(samples, voxel_cap: int, point_cap: int | None = None):
    """Returns dict with 'voxel' (VoxelBatchNp) and optionally 'points'."""
    out = {"voxel": collate_voxels(samples, voxel_cap)}
    if point_cap is not None:
        out["points"] = collate_points(samples, point_cap, voxel_cap)
    return out
