"""Labeled/unlabeled scan-split index files.

The reference loads `split_npy/.../selected_idx_in__ex_<ids>_<pct>%.npy` files
that are *absent from its snapshot* (`main.py:87-113`); this module documents
and implements their regeneration: a seeded random choice of
``ratio * num_train_scans`` scan indices (the labeled set); the unlabeled set
is the complement (`dataset_remission_mean_teacher.py:817-835`).
"""

from __future__ import annotations

import os

import numpy as np

from .labels import split_table

SEED = 1234


def generate_split_indices(num_scans: int, ratio: float, seed: int = SEED) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = int(round(num_scans * ratio))
    return np.sort(rng.choice(num_scans, size=k, replace=False))


def split_filename(dataset: str, unknown_labels, ratio: float) -> str:
    ids = "_".join(str(u) for u in unknown_labels)
    prefix = "nusc_" if dataset == "nuScenes" else ""
    return f"{prefix}selected_idx_in__ex_{ids}_{int(round(ratio * 100))}%.npy"


def ensure_split_file(
    out_dir: str, dataset: str, split: int, num_scans: int, seed: int = SEED
) -> str:
    """Create (if missing) and return the split .npy path for a split id."""
    unknown_labels, ratio = split_table(dataset, split)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, split_filename(dataset, unknown_labels, ratio))
    if not os.path.isfile(path):
        np.save(path, generate_split_indices(num_scans, ratio, seed))
    return path


def load_split_indices(path: str) -> np.ndarray:
    if not os.path.isfile(path):
        raise RuntimeError(f"Data index file does not exist: {path}")
    return np.load(path)
