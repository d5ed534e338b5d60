"""Synthetic SemanticKITTI-format mini-scans for tests and benchmarks.

The reference ships no test fixtures and expects the real SemanticKITTI
download; this generator writes procedurally-generated scans in the exact
on-disk format (`sequences/<seq>/velodyne/*.bin` float32 Nx4,
`sequences/<seq>/labels/*.label` int32 sem|inst<<16) so the full host
pipeline — reader, learning map, REAL aug, quantization, splits — can be
exercised hermetically.
"""

from __future__ import annotations

import os

import numpy as np

# raw ids used by the generator: ground-ish classes + instance classes
_GROUND = [40, 44, 48, 70, 72]  # road, parking, sidewalk, vegetation, terrain
_INSTANCE = [10, 11, 15, 18, 20, 30, 31]  # car..bicyclist
_STATIC = [50, 51, 71, 80, 81]  # building, fence, trunk, pole, traffic-sign


def synthetic_scan(rng: np.random.Generator, num_points: int = 4000):
    """One scan: ground plane + a few boxes (instances) + poles/walls."""
    n_ground = num_points // 2
    xy = rng.uniform(-40, 40, size=(n_ground, 2))
    z = rng.normal(-1.6, 0.05, size=(n_ground, 1))
    ground = np.hstack([xy, z]).astype(np.float32)
    g_labels = rng.choice(_GROUND, size=n_ground)
    g_inst = np.zeros(n_ground, np.int32)

    pts = [ground]
    labels = [g_labels]
    insts = [g_inst]
    remaining = num_points - n_ground
    inst_id = 1
    while remaining > 0:
        m = min(remaining, int(rng.integers(150, 600)))
        kind = rng.random()
        center = rng.uniform(-35, 35, size=2)
        if kind < 0.6:  # box instance (car/truck/...)
            dims = rng.uniform([1.0, 0.5, 0.4], [4.5, 2.0, 1.8])
            local = rng.uniform(-0.5, 0.5, size=(m, 3)) * dims
            p = local + np.array([center[0], center[1], -1.3 + dims[2] / 2])
            lab = int(rng.choice(_INSTANCE))
            iid = inst_id
            inst_id += 1
        else:  # vertical structure
            h = rng.uniform(1.0, 5.0)
            p = np.column_stack(
                [
                    center[0] + rng.normal(0, 0.15, m),
                    center[1] + rng.normal(0, 0.15, m),
                    rng.uniform(-1.6, -1.6 + h, m),
                ]
            )
            lab = int(rng.choice(_STATIC))
            iid = 0
        pts.append(p.astype(np.float32))
        labels.append(np.full(m, lab))
        insts.append(np.full(m, iid, np.int32))
        remaining -= m

    xyz = np.concatenate(pts)
    sem = np.concatenate(labels).astype(np.int32)
    inst = np.concatenate(insts).astype(np.int32)
    remission = rng.uniform(0, 1, size=(xyz.shape[0], 1)).astype(np.float32)
    return xyz, remission, sem, inst


def write_synthetic_kitti(
    root: str,
    sequences=("00",),
    scans_per_seq: int = 4,
    num_points: int = 4000,
    seed: int = 0,
    valid_seq: str = "08",
    valid_scans: int = 2,
):
    """Write a synthetic dataset tree; returns the root path."""
    rng = np.random.default_rng(seed)
    seq_plan = [(s, scans_per_seq) for s in sequences] + [(valid_seq, valid_scans)]
    for seq, n in seq_plan:
        vdir = os.path.join(root, "sequences", seq, "velodyne")
        ldir = os.path.join(root, "sequences", seq, "labels")
        os.makedirs(vdir, exist_ok=True)
        os.makedirs(ldir, exist_ok=True)
        for i in range(n):
            xyz, rem, sem, inst = synthetic_scan(rng, num_points)
            scan = np.hstack([xyz, rem]).astype(np.float32)
            scan.tofile(os.path.join(vdir, f"{i:06d}.bin"))
            packed = (sem.astype(np.int32) | (inst.astype(np.int32) << 16)).astype(
                np.int32
            )
            packed.tofile(os.path.join(ldir, f"{i:06d}.label"))
    return root


def synthetic_scan_learnable(rng: np.random.Generator, num_points: int = 4000):
    """A scan whose classes are geometrically + photometrically separable.

    Unlike `synthetic_scan` (labels drawn randomly within geometry groups —
    fine for pipeline plumbing, useless for measuring learning), every class
    here has a distinctive (shape, height, remission) signature so a
    segmentation model can actually learn it, and the split-1 held-out
    classes (raw 20 other-vehicle, raw 31 bicyclist — train ids 4 and 6,
    `data/labels.py:14`) are distinctive enough to be *discoverable*:
    other-vehicle = oversized high boxes at remission 0.7, bicyclist = thin
    short boxes at remission 0.95. Used by the discovery-quality experiment
    (`tools/discovery_quality.py`).
    """
    def jitter(rem, m):
        return np.clip(rem + rng.normal(0, 0.02, m), 0, 1)

    pts, labels, insts, rems = [], [], [], []

    def emit(p, lab, iid, rem):
        m = len(p)
        pts.append(np.asarray(p, np.float32))
        labels.append(np.full(m, lab, np.int32))
        insts.append(np.full(m, iid, np.int32))
        rems.append(jitter(rem, m).astype(np.float32))

    n_ground = num_points // 2
    r = np.sqrt(rng.uniform(0, 1, n_ground)) * 40
    th = rng.uniform(0, 2 * np.pi, n_ground)
    xy = np.column_stack([r * np.cos(th), r * np.sin(th)])
    road = r < 12
    side = (r >= 12) & (r < 20)
    terr = r >= 20
    z = np.where(road, -1.6, np.where(side, -1.45, -1.3))
    z = z + rng.normal(0, 0.03, n_ground) + np.where(terr, 0.15 * np.sin(xy[:, 0]), 0)
    g = np.column_stack([xy, z])
    for mask, lab, rem in ((road, 40, 0.10), (side, 48, 0.30), (terr, 72, 0.50)):
        if mask.any():
            emit(g[mask], lab, 0, rem)

    remaining = num_points - n_ground
    inst_id = 1

    def box(center, dims, m):
        local = rng.uniform(-0.5, 0.5, size=(m, 3)) * dims
        return local + np.array([center[0], center[1], -1.6 + dims[2] / 2])

    kinds = [
        # (raw label, remission, dims lo, dims hi, instance?)
        (10, 0.80, [3.8, 1.6, 1.4], [4.6, 2.0, 1.7], True),   # car
        (30, 0.40, [0.4, 0.4, 1.6], [0.6, 0.6, 1.8], True),   # person
        (20, 0.70, [6.0, 2.4, 2.6], [8.0, 3.0, 3.4], True),   # other-vehicle (held out, s1)
        (31, 0.95, [1.5, 0.4, 1.5], [1.9, 0.6, 1.7], True),   # bicyclist (held out, s1)
        (50, 0.20, [8.0, 0.4, 5.5], [14.0, 0.8, 7.0], False), # building wall
        (80, 0.90, [0.12, 0.12, 4.0], [0.2, 0.2, 6.0], False),  # pole
        (71, 0.60, [0.5, 0.5, 2.0], [0.7, 0.7, 3.0], False),  # trunk
    ]
    while remaining > 0:
        lab, rem, lo, hi, is_inst = kinds[int(rng.integers(len(kinds)))]
        m = min(remaining, int(rng.integers(120, 400)))
        center = rng.uniform(-35, 35, size=2)
        dims = rng.uniform(lo, hi)
        emit(box(center, dims, m), lab, inst_id if is_inst else 0, rem)
        if is_inst:
            inst_id += 1
        remaining -= m

    xyz = np.concatenate(pts)
    sem = np.concatenate(labels)
    inst = np.concatenate(insts)
    remission = np.concatenate(rems)[:, None]
    return xyz, remission, sem, inst


def write_learnable_kitti(
    root: str,
    sequences=("00", "01"),
    scans_per_seq: int = 20,
    num_points: int = 4000,
    seed: int = 0,
    valid_seq: str = "08",
    valid_scans: int = 8,
):
    """Like `write_synthetic_kitti` but with learnable/discoverable classes."""
    rng = np.random.default_rng(seed)
    seq_plan = [(s, scans_per_seq) for s in sequences] + [(valid_seq, valid_scans)]
    for seq, n in seq_plan:
        vdir = os.path.join(root, "sequences", seq, "velodyne")
        ldir = os.path.join(root, "sequences", seq, "labels")
        os.makedirs(vdir, exist_ok=True)
        os.makedirs(ldir, exist_ok=True)
        for i in range(n):
            xyz, rem, sem, inst = synthetic_scan_learnable(rng, num_points)
            scan = np.hstack([xyz, rem]).astype(np.float32)
            scan.tofile(os.path.join(vdir, f"{i:06d}.bin"))
            packed = (sem.astype(np.int32) | (inst.astype(np.int32) << 16)).astype(
                np.int32
            )
            packed.tofile(os.path.join(ldir, f"{i:06d}.label"))
    return root


def synth_scan_points(rng, n):
    """Geometrically simulated spinning-LiDAR scan: 64 beams x azimuth steps
    with ground + wall intersections. Near-sensor rings land multiple returns
    per 0.05 m voxel, giving the realistic ~55-70% unique-voxel ratio of real
    KITTI scans (the quantize/unique path must be driven at true dedupe).
    The port's copy of `bench.py`'s generator: same draws from the same `rng`."""
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
