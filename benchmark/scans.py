"""The benchmark's traffic generator: synthetic SemanticKITTI scans.

Frozen copies, so that a later change to the program cannot change the
traffic: `synth_scan_points` is `gcdlss_tpu_torch/data/synthetic.py`'s
generator and `write_tree` is `chip_smoke.write_kitti_tree`, both as of
commit 7a989cf, the tree writer taking its sizes from the traffic file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# SemanticKITTI's raw ids of its 19 train classes (`learning_map_inv`)
RAW_IDS = (10, 11, 15, 18, 20, 30, 31, 32, 40, 44, 48, 49, 50, 51, 70, 71, 72, 80, 81)


def synth_scan_points(rng, n):
    """Geometrically simulated spinning-LiDAR scan: 64 beams x azimuth steps
    with ground + wall intersections. Near-sensor rings land multiple returns
    per 0.05 m voxel, giving the realistic ~55-70% unique-voxel ratio of real
    KITTI scans."""
    beams = 64
    per_beam = n // beams
    elev = np.deg2rad(np.linspace(-24.0, 2.0, beams))  # HDL-64-ish
    az = rng.uniform(0, 2 * np.pi, (beams, per_beam))
    e = np.broadcast_to(elev[:, None], (beams, per_beam))
    h = 1.73  # sensor height
    # range to ground plane (capped at 80 m); upward beams hit "walls"
    rng_ground = np.where(np.sin(e) < -1e-3, h / np.maximum(-np.sin(e), 1e-3), 80.0)
    wall_r = rng.uniform(4, 60, (beams, per_beam))
    hits_wall = rng.random((beams, per_beam)) < 0.35
    r = np.minimum(rng_ground, np.where(hits_wall, wall_r, np.inf))
    r = np.minimum(r, 80.0)
    x = (r * np.cos(e) * np.cos(az)).reshape(-1)
    y = (r * np.cos(e) * np.sin(az)).reshape(-1)
    z = (h + r * np.sin(e)).reshape(-1)
    pts = np.stack([x, y, z], 1)[: n]
    if pts.shape[0] < n:
        pts = np.concatenate([pts, pts[: n - pts.shape[0]]])
    return (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)


def write_tree(root: Path, rng, scans: int, points: int) -> list:
    """SemanticKITTI layout, sequence 00: `scans` scans of `points` points
    with a uniform remission and raw labels drawn from the 19 classes (no
    instance ids). Returns [(scan file, label file)]."""
    vdir = root / "sequences" / "00" / "velodyne"
    ldir = root / "sequences" / "00" / "labels"
    vdir.mkdir(parents=True, exist_ok=True)
    ldir.mkdir(parents=True, exist_ok=True)
    raw = np.array(RAW_IDS, np.int32)
    files = []
    for i in range(scans):
        pts = synth_scan_points(rng, points)
        rem = rng.uniform(0, 1, (points, 1)).astype(np.float32)
        scan, label = vdir / f"{i:06d}.bin", ldir / f"{i:06d}.label"
        np.hstack([pts, rem]).astype(np.float32).tofile(scan)
        rng.choice(raw, points).astype(np.int32).tofile(label)
        files.append((str(scan), str(label)))
    return files
