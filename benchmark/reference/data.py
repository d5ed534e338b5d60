"""Plain NumPy reference of what the Stage-2 loaders hand the step.

It works the batches out again from the raw scan and label files and the
seeds, as SemanticKITTI's Stage-2 datasets define them: random downsampling
to `downsampling` points (sorted indices), the learning map, the
known/unknown compression (the labeled side with the synthetic resize label
100 in the unknown slot), a random rotation about each axis (+-pi/20, in a
random order) and a scale in [0.95, 1.05], voxel quantization with
unique / inverse maps, and the fixed-capacity collation of a loader batch.
Each scan's draws come from a generator of its own, seeded by (dataset seed,
pass, index); a loader's scan order from one generator seeded by the loader.
"""

from __future__ import annotations

import numpy as np

# SemanticKITTI raw label -> train label (-1 ignored), and train -> raw
LEARNING_MAP = {
    0: -1, 1: -1, 10: 0, 11: 1, 13: 4, 15: 2, 16: 4, 18: 3, 20: 4, 30: 5,
    31: 6, 32: 7, 40: 8, 44: 9, 48: 10, 49: 11, 50: 12, 51: 13, 52: -1,
    60: 8, 70: 14, 71: 15, 72: 16, 80: 17, 81: 18, 99: -1, 252: 0, 253: 6,
    254: 5, 255: 7, 256: 4, 257: 4, 258: 3, 259: 4,
}
LEARNING_MAP_INV = {
    -1: 0, 0: 10, 1: 11, 2: 15, 3: 18, 4: 20, 5: 30, 6: 31, 7: 32, 8: 40,
    9: 44, 10: 48, 11: 49, 12: 50, 13: 51, 14: 70, 15: 71, 16: 72, 17: 80,
    18: 81,
}
NUM_TRAIN_LABELS = 19
SYNTHETIC_LABEL = 100  # the resize augmentation's label for a rescaled instance


def label_space(unknown: list) -> dict:
    """Known train labels compressed to 0..K-1 in order, every unknown one to
    K (the unknown slot)."""
    known = [lab for lab in sorted(LEARNING_MAP_INV) if lab >= 0 and lab not in unknown]
    mapping = {lab: i for i, lab in enumerate(known)}
    k = len(known)
    mapping.update({lab: k for lab in unknown})
    return {"mapping": mapping, "num_known": k, "num_novel": len(unknown),
            "unknown_label": k, "unknown": list(unknown)}


def _lut(table: dict, size: int) -> np.ndarray:
    lut = np.full(size, -1, np.int32)
    for k, v in table.items():
        if k >= 0:
            lut[k] = v
    return lut


def _rotation(axis: int, theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(3)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s if axis != 1 else s
    m[j, i] = s if axis != 1 else -s
    return m


def _augmentation(rng: np.random.Generator) -> np.ndarray:
    mats = [_rotation(axis, rng.uniform(-np.pi / 20, np.pi / 20)) for axis in range(3)]
    rng.shuffle(mats)
    affine = np.eye(4)
    affine[:3, :3] = mats[0] @ mats[1] @ mats[2]
    scale = np.eye(4)
    np.fill_diagonal(scale[:3, :3], rng.uniform(0.95, 1.05))
    return affine @ scale


def quantize(points: np.ndarray, voxel_size: float):
    """(coords [M, 3] int32 in (x, y, z) order, first point of each voxel,
    voxel of each point)."""
    q = np.floor(points / voxel_size).astype(np.int64)
    off = 1 << 20
    key = ((q[:, 0] + off) << 42) | ((q[:, 1] + off) << 21) | (q[:, 2] + off)
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    return q[first].astype(np.int32), first.astype(np.int64), inverse.reshape(-1).astype(np.int64)


class Side:
    """One side of the step's feed: its scan files in dataset order, the
    dataset's seed, whether it is the labeled side, and the loader's seed."""

    def __init__(self, scans: list, labels: list, dataset_seed: int, labeled: bool,
                 loader_seed: int, space: dict, voxel_size: float, downsampling: int):
        self.scans, self.labels = scans, labels
        self.dataset_seed, self.labeled, self.loader_seed = dataset_seed, labeled, loader_seed
        self.voxel_size, self.downsampling = voxel_size, downsampling
        mapping = dict(space["mapping"])
        if labeled:  # the resize augmentation's label goes to the unknown slot
            mapping[SYNTHETIC_LABEL] = NUM_TRAIN_LABELS - len(space["unknown"])
        self.map_lut = _lut(mapping, max(mapping) + 1)
        self.train_lut = _lut(LEARNING_MAP, 261)

    def sample(self, index: int, epoch: int) -> dict:
        rng = np.random.default_rng([int(self.dataset_seed), int(epoch), int(index)])
        scan = np.fromfile(self.scans[index], dtype=np.float32).reshape(-1, 4)
        xyz, feat = scan[:, :3].copy(), scan[:, 3:4].copy()
        sel = np.arange(xyz.shape[0])
        if xyz.shape[0] > self.downsampling:
            sel = np.sort(rng.choice(xyz.shape[0], self.downsampling, replace=False))
            xyz, feat = xyz[sel], feat[sel]
        raw = np.fromfile(self.labels[index], dtype=np.int32).reshape(-1)[sel]
        sem, inst = raw & 0xFFFF, raw >> 16
        labels = self.train_lut[np.clip(sem, 0, 260)]
        keep = labels != -1
        xyz, feat, labels, inst, sel = xyz[keep], feat[keep], labels[keep], inst[keep], sel[keep]
        if self.labeled and np.any(inst != 0):
            # the resize augmentation draws only where instances exist; the
            # benchmark's scans carry none, and this reference covers no other
            raise NotImplementedError("instance ids in a labeled scan: resize not covered")
        mapped = self.map_lut[labels]
        mtx = _augmentation(rng)
        homo = np.hstack([xyz, np.ones((xyz.shape[0], 1), xyz.dtype)])
        xyz = (homo @ mtx.T[:, :3]).astype(np.float32)
        coords, first, inverse = quantize(xyz, self.voxel_size)
        return {"points": xyz, "features": feat.astype(np.float32),
                "labels": labels.astype(np.int32), "mapped": mapped.astype(np.int32),
                "voxel_coords": coords, "voxel_features": feat[first].astype(np.float32),
                "voxel_labels": labels[first].astype(np.int32),
                "voxel_mapped": mapped[first].astype(np.int32), "inverse": inverse}

    def order(self, batch: int) -> list:
        """The scan indices of each batch of the loader's first pass."""
        order = np.arange(len(self.scans))
        np.random.default_rng(self.loader_seed).shuffle(order)
        n = len(order) // batch
        return [order[i * batch:(i + 1) * batch] for i in range(n)]


def collate(samples: list, voxel_cap: int, point_cap: int) -> dict:
    """The scans of one batch packed into fixed capacities: voxels of scan i
    after those of the scans before it (batch index i), points per scan, and
    each point's row in the packed voxels (`voxel_cap` where it has none)."""
    b = len(samples)
    out = {"coords": np.zeros((voxel_cap, 4), np.int32),
           "feats": np.zeros((voxel_cap, 1), np.float32),
           "labels": np.full(voxel_cap, -1, np.int32),
           "mapped_labels": np.full(voxel_cap, -1, np.int32),
           "valid": np.zeros(voxel_cap, bool),
           "xyz": np.zeros((b, point_cap, 3), np.float32),
           "point_feats": np.zeros((b, point_cap, 1), np.float32),
           "point_labels": np.full((b, point_cap), -1, np.int32),
           "point_mapped": np.full((b, point_cap), -1, np.int32),
           "point_valid": np.zeros((b, point_cap), bool),
           "voxel_row": np.full((b, point_cap), voxel_cap, np.int32)}
    off = 0
    for i, s in enumerate(samples):
        take = min(s["voxel_coords"].shape[0], voxel_cap - off)
        sl = slice(off, off + take)
        out["coords"][sl, 0] = i
        out["coords"][sl, 1:] = s["voxel_coords"][:take]
        out["feats"][sl] = s["voxel_features"][:take]
        out["labels"][sl] = s["voxel_labels"][:take]
        out["mapped_labels"][sl] = s["voxel_mapped"][:take]
        out["valid"][sl] = True
        n = min(s["points"].shape[0], point_cap)
        out["xyz"][i, :n] = s["points"][:n]
        out["point_feats"][i, :n] = s["features"][:n]
        out["point_labels"][i, :n] = s["labels"][:n]
        out["point_mapped"][i, :n] = s["mapped"][:n]
        out["point_valid"][i, :n] = True
        inv = s["inverse"][:n]
        out["voxel_row"][i, :n] = np.where(inv < take, off + inv, voxel_cap)
        off += take
    return out


def batches(side: Side, steps: int, scans: int, voxel_cap: int, point_cap: int) -> list:
    """The first `steps` batches of `scans` scans the side's loader yields."""
    return [collate([side.sample(int(i), 0) for i in idx], voxel_cap, point_cap)
            for idx in side.order(scans)[:steps]]
