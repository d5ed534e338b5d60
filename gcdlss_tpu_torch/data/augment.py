"""Host-side point-cloud augmentations (numpy).

Rebuilds: random rotation/scale matrix generation (`utils/voxelizer.py:41-74`),
REAL instance-resize OOD synthesis (`ds_sample`,
`utils/dataset_remission_mean_teacher.py:1029-1059`), and PolarMix
(`utils/utils_polarmix.py:11-76`). LaserMix runs on the device inside the
Stage-2 step (see `gcdlss_tpu_torch/train/lasermix.py`); a numpy twin lives
here for tests.
"""

from __future__ import annotations

import numpy as np


def _axis_rotation(axis: int, theta: float) -> np.ndarray:
    """Rotation matrix around a coordinate axis (Rodrigues on a unit axis)."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(3)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s if axis != 1 else s
    m[j, i] = s if axis != 1 else -s
    return m


def random_transformation(
    rng: np.random.Generator,
    scale_bound=(0.95, 1.05),
    rotation_bound=((-np.pi / 20, np.pi / 20),) * 3,
    translation_bound=None,
):
    """4x4 rigid+scale augmentation matrix: random per-axis rotations composed
    in random order, then isotropic scale (and optional translation)."""
    rot = np.eye(3)
    if rotation_bound is not None:
        mats = []
        for axis, bound in enumerate(rotation_bound):
            theta = rng.uniform(*bound) if bound is not None else 0.0
            mats.append(_axis_rotation(axis, theta))
        rng.shuffle(mats)
        rot = mats[0] @ mats[1] @ mats[2]
    affine = np.eye(4)
    affine[:3, :3] = rot
    if translation_bound is not None:
        affine[:3, 3] = [rng.uniform(*b) for b in translation_bound]
    scale_mtx = np.eye(4)
    if scale_bound is not None:
        np.fill_diagonal(scale_mtx[:3, :3], rng.uniform(*scale_bound))
    return affine @ scale_mtx


def apply_transformation(points: np.ndarray, mtx: np.ndarray) -> np.ndarray:
    homo = np.hstack([points, np.ones((points.shape[0], 1), points.dtype)])
    return (homo @ mtx.T[:, :3]).astype(np.float32)


def real_instance_resize(
    rng: np.random.Generator,
    xyz: np.ndarray,
    labels: np.ndarray,
    instances: np.ndarray,
    unknown_classes,
    synthetic_label: int = 100,
    min_points: int = 300,
):
    """REAL augmentation: randomly rescale large instances of *known* classes
    (x1.5-3 or x0.25-0.5 about their centroid) and relabel them to the
    synthetic-unknown id. Operates in place on copies; returns (xyz, labels)."""
    xyz = xyz.copy()
    labels = labels.copy()
    inst = instances.reshape(-1)
    cls, cnt = np.unique(inst, return_counts=True)
    big = cls[cnt >= min_points][1:]  # skip the background instance id
    for iid in big:
        m = inst == iid
        if rng.random() > 0.5 or labels[m][0] in unknown_classes:
            continue
        center = xyz[m].mean(axis=0)
        scale = rng.random() * 1.5 + 1.5 if rng.random() > 0.5 else rng.random() * 0.25 + 0.25
        xyz[m] = (xyz[m] - center) * scale + center
        labels[m] = synthetic_label
    return xyz, labels


# ------------------------------------------------------------------- PolarMix

KITTI_INSTANCE_CLASSES = [0, 1, 2, 3, 4, 5, 6, 7]


def polarmix(
    rng: np.random.Generator,
    pts1, labels1, pts2, labels2,
    alpha: float, beta: float,
    instance_classes=KITTI_INSTANCE_CLASSES,
    omega=(np.pi / 3, 2 * np.pi / 3),
):
    """Azimuth-sector swap + instance rotate-paste between two scans."""
    out_pts, out_labels = pts1, labels1
    if rng.random() < 0.5:
        yaw1 = -np.arctan2(pts1[:, 1], pts1[:, 0])
        yaw2 = -np.arctan2(pts2[:, 1], pts2[:, 0])
        in1 = (yaw1 > alpha) & (yaw1 < beta)
        in2 = (yaw2 > alpha) & (yaw2 < beta)
        out_pts = np.concatenate([pts1[~in1], pts2[in2]])
        out_labels = np.concatenate([labels1[~in1], labels2[in2]])
    # rotate-paste instances from scan 2
    inst_mask = np.isin(labels2, instance_classes)
    pts_inst, labels_inst = pts2[inst_mask], labels2[inst_mask]
    copies_p = [pts_inst]
    copies_l = [labels_inst]
    for w in omega:
        rot = np.array(
            [[np.cos(w), np.sin(w), 0], [-np.sin(w), np.cos(w), 0], [0, 0, 1]],
            np.float32,
        )
        p = pts_inst.copy()
        p[:, :3] = pts_inst[:, :3] @ rot
        copies_p.append(p)
        copies_l.append(labels_inst)
    out_pts = np.concatenate([out_pts] + copies_p)
    out_labels = np.concatenate([out_labels] + copies_l)
    return out_pts, out_labels


# ------------------------------------------------------- LaserMix (numpy twin)

def lasermix_masks(
    pitch_sup: np.ndarray,
    pitch_unsup: np.ndarray,
    num_areas: int,
    pitch_range=(-25.0, 3.0),
):
    """Pitch-band parity masks. Returns (sup_in_mix1, unsup_in_mix1); mix2 is
    the complement. Even bands (from the top) go to mix1 from sup."""
    down = pitch_range[0] / 180 * np.pi
    up = pitch_range[1] / 180 * np.pi
    ps = np.clip(pitch_sup, down + 1e-5, up - 1e-5)
    pu = np.clip(pitch_unsup, down + 1e-5, up - 1e-5)
    step = (up - down) / num_areas
    band_s = np.clip(((up - ps) / step).astype(np.int64), 0, num_areas - 1)
    band_u = np.clip(((up - pu) / step).astype(np.int64), 0, num_areas - 1)
    return band_s % 2 == 0, band_u % 2 == 1
