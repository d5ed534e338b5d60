"""SemanticKITTI host data pipeline.

Rebuilds the reference dataset stack (`utils/dataset_remission_mean_teacher.py:742-1059`,
`utils/dataset_remission.py:693-888`) as one configurable dataset class:

  * `.bin` scans: float32 [N,4] xyz + remission; features = remission column.
  * `.label`: int32; semantic = low 16 bits, instance = high 16 bits.
  * learning-map to train labels (-1 = ignore), drop ignored points.
  * random downsample to `downsampling` points (sorted indices).
  * REAL instance-resize augmentation (labeled side only).
  * known/unknown compression via `label_mapping` (+ synthetic label 100 ->
    the unknown slot, reference `:838-841`).
  * random rotation (±pi/20 per axis, random order) + scale (0.95-1.05).
  * voxel quantization at `voxel_size` with unique/inverse maps.

Dataset "types" mirror the reference factory
(`dataset_remission_mean_teacher.py:19-39`): `labeled` (full scans, val),
`disjoint` (Stage-1 labeled train), `lasermix` (Stage-2: returns both point-
and voxel-level tensors), `polarmix`.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

from .meta import dataset_meta, learning_map_lut
from .quantize_np import sparse_quantize_np
from . import augment as aug


@dataclass
class ScanSample:
    """One scan after host preprocessing (numpy)."""

    points: np.ndarray  # [n, 3] float32 (augmented)
    features: np.ndarray  # [n, 1] float32 remission
    labels: np.ndarray  # [n] int32 train labels (0..K_total-1; 100->mapped)
    mapped_labels: np.ndarray  # [n] int32 compressed labels
    voxel_coords: np.ndarray  # [m, 3] int32
    voxel_features: np.ndarray  # [m, 1]
    voxel_labels: np.ndarray  # [m]
    voxel_mapped_labels: np.ndarray  # [m]
    selected_idx: np.ndarray  # [m] original point indices of voxel reps
    inverse_map: np.ndarray  # [n] point -> voxel
    scan_idx: int = 0


def base_seed(seed: int | None) -> int:
    """The base of a dataset's per-scan generators (`get`,
    `loader.scan_rng`); a dataset made without a seed draws one, so that
    its runs still differ."""
    return int(np.random.SeedSequence().entropy % (1 << 63)) if seed is None else int(seed)


def read_scan(path: str):
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return scan[:, :3].copy(), scan[:, 3:4].copy()


def read_label(path: str):
    raw = np.fromfile(path, dtype=np.int32).reshape(-1)
    return raw & 0xFFFF, raw >> 16


class SemanticKITTIDataset:
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
        num_train_labels: int = 19,
        seed: int | None = None,
        sequences=None,
        polarmix: bool = False,
        percentage: float = 100.0,
        dataset_name: str = "SemanticKITTI",
    ):
        self.meta = dataset_meta(dataset_name)
        self.root = root
        self.voxel_size = voxel_size
        self.downsampling = downsampling
        self.augment = augment and split == "train"
        self.resize_aug = resize_aug
        self.output_point_level = output_point_level
        self.unknown_labels = list(unknown_labels)
        self.labeled = labeled
        self.has_labels = (labeled and split != "test") or store_unlabeled_label
        self.rng = np.random.default_rng(seed)
        self.seed = base_seed(seed)
        self.lut = learning_map_lut(self.meta["learning_map"])

        self.scan_files: list = []
        self.label_files: list = []
        if sequences is None:
            # use whichever of the canonical split sequences exist on disk
            # (lets fixture datasets ship a subset of sequences)
            canonical = self.meta["split_sequence"][split]
            sequences = [
                s for s in canonical
                if os.path.isdir(os.path.join(root, "sequences", s))
            ] or canonical
        for seq in sequences:
            vdir = os.path.join(root, "sequences", seq, "velodyne")
            ldir = os.path.join(root, "sequences", seq, "labels")
            if not os.path.isdir(vdir):
                raise RuntimeError(f"Point cloud directory missing: {vdir}")
            names = sorted(os.listdir(vdir))
            self.scan_files += [os.path.join(vdir, n) for n in names]
            if self.has_labels:
                self.label_files += [
                    os.path.join(ldir, n.replace(".bin", ".label")) for n in names
                ]

        if percentage < 100.0 and split == "train":
            # toy subsets (`SemanticKITTIGCDToyDataset`,
            # `dataset_remission.py:1421-1453`): the reference ships pre-built
            # `..._train.{p}.pkl` scan subsets; we take a deterministic evenly
            # spaced p% of the scan list instead
            keep = np.linspace(
                0, len(self.scan_files) - 1,
                max(1, int(round(len(self.scan_files) * percentage / 100.0))),
            ).round().astype(int)
            keep = np.unique(keep)
            self.scan_files = [self.scan_files[i] for i in keep]
            if self.has_labels:
                self.label_files = [self.label_files[i] for i in keep]

        if split_indices is not None:
            all_idx = np.arange(len(self.scan_files))
            keep = (
                np.asarray(split_indices)
                if labeled
                else np.setdiff1d(all_idx, np.asarray(split_indices))
            )
            self.scan_files = [self.scan_files[i] for i in keep]
            if self.has_labels:
                self.label_files = [self.label_files[i] for i in keep]

        if label_mapping is not None:
            mapping = dict(label_mapping)
            if self.resize_aug:
                # synthetic label 100 -> unknown slot (= 19 - #unknown)
                mapping[100] = num_train_labels - len(self.unknown_labels)
            max_key = max(mapping.keys())
            self.map_lut = np.full(max_key + 1, -1, np.int32)
            for k, v in mapping.items():
                if k >= 0:
                    self.map_lut[k] = v
        else:
            self.map_lut = None
        self.polarmix = polarmix
        self.num_files = len(self.scan_files)

    def __len__(self):
        return self.num_files

    def _load_mapped(self, t: int, rng):
        """Load scan t with downsample + label decode (for PolarMix pairing)."""
        xyz, feat = read_scan(self.scan_files[t])
        sel = np.arange(xyz.shape[0])
        if self.downsampling != -1 and xyz.shape[0] > self.downsampling:
            sel = np.sort(
                rng.choice(xyz.shape[0], self.downsampling, replace=False)
            )
            xyz, feat = xyz[sel], feat[sel]
        sem, _ = read_label(self.label_files[t])
        sem = sem[sel]
        labels = self.lut[np.clip(sem, 0, self.lut.shape[0] - 1)]
        keep = labels != -1
        return xyz[keep], feat[keep], labels[keep].astype(np.int32)

    def __getitem__(self, t: int) -> ScanSample:
        """Scan t, its random draws taken from the dataset's one generator."""
        return self.get(t, self.rng)

    def get(self, t: int, rng: np.random.Generator) -> ScanSample:
        """Scan t, every random draw (downsampling, instance resize,
        PolarMix, rotation and scale) taken from `rng`."""
        xyz, feat = read_scan(self.scan_files[t])

        sel = np.arange(xyz.shape[0])
        if self.augment and self.downsampling != -1 and xyz.shape[0] > self.downsampling:
            sel = np.sort(
                rng.choice(xyz.shape[0], self.downsampling, replace=False)
            )
            xyz, feat = xyz[sel], feat[sel]

        if self.has_labels:
            sem, inst = read_label(self.label_files[t])
            sem, inst = sem[sel], inst[sel]
            labels = self.lut[np.clip(sem, 0, self.lut.shape[0] - 1)]
            keep = labels != -1
            xyz, feat, labels, inst, sel = (
                xyz[keep], feat[keep], labels[keep], inst[keep], sel[keep],
            )
            if self.resize_aug:
                xyz, labels = aug.real_instance_resize(
                    rng, xyz, labels, inst, self.unknown_labels
                )
            mapped = (
                self.map_lut[labels] if self.map_lut is not None else labels.copy()
            )
        else:
            labels = np.full(xyz.shape[0], -1, np.int32)
            mapped = labels.copy()

        if self.polarmix and self.augment and self.has_labels:
            # PolarMix: azimuth-sector swap + instance rotate-paste with a
            # second random scan (`dataset_remission_mean_teacher.py:1243-1262`)
            other = self._load_mapped(int(rng.integers(0, self.num_files)), rng)
            alpha = (rng.random() - 1.0) * np.pi
            beta = alpha + np.pi
            omega = (
                rng.random() * np.pi * 2 / 3,
                (rng.random() + 1) * np.pi * 2 / 3,
            )
            scan1 = np.concatenate([xyz, feat], axis=1)
            scan2 = np.concatenate([other[0], other[1]], axis=1)
            mixed, mixed_labels = aug.polarmix(
                rng, scan1, labels, scan2, other[2],
                alpha=alpha, beta=beta, omega=omega,
            )
            xyz = mixed[:, :3].astype(np.float32)
            feat = mixed[:, 3:4].astype(np.float32)
            labels = mixed_labels.astype(np.int32)
            mapped = (
                self.map_lut[labels] if self.map_lut is not None else labels.copy()
            )
            sel = np.arange(xyz.shape[0])

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


class SemanticPOSSDataset(SemanticKITTIDataset):
    """SemanticPOSS (same on-disk layout as SemanticKITTI; 13 train classes).

    Rebuild of `utils/dataset.py:1875-2190` on the unified loader."""

    def __init__(self, root, split="train", *, num_train_labels: int = 13, **kw):
        kw.setdefault("dataset_name", "SemanticPOSS")
        super().__init__(root, split, num_train_labels=num_train_labels, **kw)


# dataset-type presets: keyword defaults applied by the factory, mirroring
# the reference's per-type dataset classes (which differ only in these flags):
#   labeled/unlabeled — split-index selection side (`dataset_remission.py:20-25`)
#   disjoint — labeled side, no extras (`SemanticKITTIRestrictedDisjointDataset`)
#   gcd/dual — structural duplicates of disjoint in the reference
#     (`dataset_remission.py:1137`, `dataset.py:888` — their __getitem__ returns
#     the identical 7-tuple); kept as aliases for API parity
#   finetuning — REAL-aug instance resize on (`dataset.py:1084`, resize_aug=True)
#   lasermix — point+voxel two-level output for in-step re-mixing
#     (`dataset_remission_mean_teacher.py:742-1059`)
#   polarmix — PolarMix scan pairing (`dataset_remission_mean_teacher.py:1061`)
_TYPE_PRESETS: dict = {
    "labeled": dict(labeled=True),
    "unlabeled": dict(labeled=False),
    "disjoint": dict(labeled=True),
    "gcd": dict(labeled=True),
    "dual": dict(labeled=True),
    "finetuning": dict(labeled=True, resize_aug=True),
    "lasermix": dict(output_point_level=True),
    "polarmix": dict(polarmix=True),
    "toy": dict(labeled=True),
}


def get_dataset(name: str, dtype: str = "disjoint"):
    """Factory mirroring `dataset_remission_mean_teacher.get_dataset:19-39`.

    Returns a constructor with the type's keyword presets applied (callers may
    still override any of them explicitly).
    """
    if dtype not in _TYPE_PRESETS:
        raise NameError(f'Dataset type "{dtype}" is not implemented')
    if name == "SemanticKITTI":
        cls = SemanticKITTIDataset
    elif name == "SemanticPOSS":
        cls = SemanticPOSSDataset
    elif name == "nuScenes":
        from .nuscenes import NuScenesDataset

        cls = NuScenesDataset
    else:
        raise NameError(f"Dataset {name} not implemented")

    preset = _TYPE_PRESETS[dtype]

    def make(*args, **kw):
        merged = {**preset, **kw}
        return cls(*args, **merged)

    make.__name__ = f"{cls.__name__}[{dtype}]"
    return make


def parse_unknown_labels_from_split_file(path: str):
    """The reference encodes unknown ids in the split filename
    (`..._ex_4_6_50%.npy` -> [4, 6]); keep that convention readable."""
    nums = [int(x) for x in re.findall(r"\d+", os.path.basename(path))]
    return nums[:-1]
