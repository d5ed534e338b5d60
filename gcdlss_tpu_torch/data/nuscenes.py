"""nuScenes-lidarseg host data pipeline (devkit-free).

Rebuild of `nuScenes_LaserMix_RealAug_Dataset`
(`utils/dataset_remission_mean_teacher.py:1979-2267`):
  * scans: `.bin` float32 [N,5] (xyz, intensity, ring); features = intensity;
  * labels: panoptic `.npz` ('data' uint16): semantic = label//1000,
    instance = label%1000; 32->16-class learning map;
  * scan list from `nuscenes_infos_{train,val}.pkl`;
  * REAL aug maps synthetic label 100 -> 16 - #unknown (`:2071-2074`).

The reference needs the nuscenes devkit only to resolve sample tokens to
panoptic filenames (`:2092-2097`); here each info entry may instead carry a
`panoptic_path` (our fixture writer emits these), or a token->filename dict
can be passed (`panoptic_index`, buildable once from panoptic.json without the
devkit).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .meta import dataset_meta, learning_map_lut
from .quantize_np import sparse_quantize_np
from . import augment as aug
from .semantic_kitti import ScanSample, base_seed


def decode_panoptic(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(semantic, instance) from nuScenes panoptic packing.

    Exactly `sem = label // 1000`, `inst = label % 1000`
    (`utils/dataset_remission_mean_teacher.py:2101-2103`; the reference's
    uint8 cast of sem is a no-op for valid raw ids < 32). Golden-tested in
    tests/test_nuscenes.py against hand-packed label files."""
    raw = np.asarray(raw).reshape(-1)
    return (raw // 1000).astype(np.int64), (raw % 1000).astype(np.int32)


class NuScenesDataset:
    def __init__(
        self,
        root: str,
        split: str = "train",
        *,
        split_indices: np.ndarray | None = None,
        labeled: bool = True,
        voxel_size: float = 0.05,
        downsampling: int = 80000,
        augment: bool = False,
        label_mapping: dict | None = None,
        unknown_labels=(),
        resize_aug: bool = False,
        output_point_level: bool = False,
        store_unlabeled_label: bool = True,
        num_train_labels: int = 16,
        seed: int | None = None,
        panoptic_index: dict | None = None,
        sequences=None,
    ):
        self.meta = dataset_meta("nuScenes")
        self.root = root
        self.voxel_size = voxel_size
        self.downsampling = downsampling
        self.augment = augment and split == "train"
        self.resize_aug = resize_aug
        self.unknown_labels = list(unknown_labels)
        self.rng = np.random.default_rng(seed)
        self.seed = base_seed(seed)
        self.lut = learning_map_lut(self.meta["learning_map"], max_raw=40)
        self.panoptic_index = panoptic_index or {}

        name = {"train": "train", "valid": "val", "test": "test"}[split]
        with open(os.path.join(root, f"nuscenes_infos_{name}.pkl"), "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data

        if split_indices is not None:
            all_idx = np.arange(len(infos))
            keep = (
                np.asarray(split_indices)
                if labeled
                else np.setdiff1d(all_idx, np.asarray(split_indices))
            )
            infos = [infos[i] for i in keep]
        self.infos = infos

        if label_mapping is not None:
            mapping = dict(label_mapping)
            if self.resize_aug:
                mapping[100] = num_train_labels - len(self.unknown_labels)
            max_key = max(mapping.keys())
            self.map_lut = np.full(max_key + 1, -1, np.int32)
            for k, v in mapping.items():
                if k >= 0:
                    self.map_lut[k] = v
        else:
            self.map_lut = None
        self.num_files = len(infos)

    def __len__(self):
        return self.num_files

    # allow --debug style truncation (reference slices nusc_infos)
    @property
    def nusc_infos(self):
        return self.infos

    @nusc_infos.setter
    def nusc_infos(self, v):
        self.infos = v
        self.num_files = len(v)

    def _panoptic_path(self, info) -> str:
        if "panoptic_path" in info:
            return os.path.join(self.root, info["panoptic_path"])
        tok = info.get("token")
        if tok in self.panoptic_index:
            return os.path.join(self.root, self.panoptic_index[tok])
        raise RuntimeError(
            "cannot resolve panoptic labels: provide 'panoptic_path' in infos "
            "or a panoptic_index mapping (see data/nuscenes.py docstring)"
        )

    def __getitem__(self, t: int) -> ScanSample:
        """Scan t, its random draws taken from the dataset's one generator."""
        return self.get(t, self.rng)

    def get(self, t: int, rng: np.random.Generator) -> ScanSample:
        """Scan t, every random draw taken from `rng`."""
        info = self.infos[t]
        pts = np.fromfile(
            os.path.join(self.root, info["lidar_path"]), dtype=np.float32
        ).reshape(-1, 5)
        xyz = pts[:, :3].copy()
        feat = pts[:, 3:4].copy()

        raw = np.load(self._panoptic_path(info))["data"]
        sem_raw, inst = decode_panoptic(raw)
        labels = self.lut[np.clip(sem_raw, 0, self.lut.shape[0] - 1)]

        sel = np.arange(xyz.shape[0])
        if self.augment and self.downsampling != -1:
            n = min(self.downsampling, xyz.shape[0])
            sel = np.sort(rng.choice(xyz.shape[0], n, replace=False))
            xyz, feat, labels, inst = xyz[sel], feat[sel], labels[sel], inst[sel]

        keep = labels != -1
        xyz, feat, labels, inst, sel = (
            xyz[keep], feat[keep], labels[keep], inst[keep], sel[keep],
        )
        if self.resize_aug:
            xyz, labels = aug.real_instance_resize(
                rng, xyz, labels, inst, self.unknown_labels
            )
        mapped = self.map_lut[labels] if self.map_lut is not None else labels.copy()

        if self.augment:
            mtx = aug.random_transformation(rng)
            xyz = aug.apply_transformation(xyz, mtx)

        coords, unique_map, inverse_map = sparse_quantize_np(xyz, self.voxel_size)
        return ScanSample(
            points=xyz.astype(np.float32),
            features=feat.astype(np.float32),
            labels=labels.astype(np.int32),
            mapped_labels=mapped.astype(np.int32),
            voxel_coords=coords,
            voxel_features=feat[unique_map].astype(np.float32),
            voxel_labels=labels[unique_map].astype(np.int32),
            voxel_mapped_labels=mapped[unique_map].astype(np.int32),
            selected_idx=sel[unique_map].astype(np.int64),
            inverse_map=inverse_map,
            scan_idx=t,
        )


def write_synthetic_nuscenes(root: str, num_scans: int = 4,
                             num_points: int = 3000, seed: int = 0,
                             split: str = "train"):
    """Synthetic nuScenes-format fixture (infos pkl + bins + panoptic npz)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)
    os.makedirs(os.path.join(root, "panoptic"), exist_ok=True)
    infos = []
    raw_classes = list(dataset_meta("nuScenes")["learning_map"].keys())
    for i in range(num_scans):
        xyz = rng.uniform(-40, 40, (num_points, 3)).astype(np.float32)
        xyz[:, 2] = rng.normal(-1.5, 1.0, num_points)
        inten = rng.uniform(0, 255, (num_points, 1)).astype(np.float32)
        ring = rng.integers(0, 32, (num_points, 1)).astype(np.float32)
        pts = np.hstack([xyz, inten, ring]).astype(np.float32)
        lp = f"samples/scan_{i:04d}.bin"
        pts.tofile(os.path.join(root, lp))
        sem = rng.choice(raw_classes, num_points)
        inst = rng.integers(0, 5, num_points)
        packed = (sem * 1000 + inst).astype(np.uint16)
        pp = f"panoptic/scan_{i:04d}.npz"
        np.savez_compressed(os.path.join(root, pp), data=packed)
        infos.append({"lidar_path": lp, "panoptic_path": pp, "token": f"tok{i}"})
    name = {"train": "train", "valid": "val", "test": "test"}[split]
    with open(os.path.join(root, f"nuscenes_infos_{name}.pkl"), "wb") as f:
        pickle.dump({"infos": infos}, f)
    return root
