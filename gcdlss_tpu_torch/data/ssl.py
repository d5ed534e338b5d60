"""Self-supervised two-view dataset wrappers.

Rebuild of `utils/dataset_remission.py:2554-2608` (`dataset_wrapper`,
`swav_wrapper_ssl`) and the `TransformTwice` pattern: each item yields two
independently augmented views of the same scan (the per-view randomness comes
from the underlying dataset's augmentation RNG), for SwAV/SimGCD-style
pretraining with `models.wrappers.MultiHeadSelfSupMinkUnet`.
"""

from __future__ import annotations

import numpy as np

from .collation import collate_batch


class TwoViewDataset:
    """Wraps an augmenting dataset; __getitem__(i) -> (view_a, view_b)."""

    def __init__(self, dataset):
        assert getattr(dataset, "augment", False), (
            "two-view wrapper needs an augmenting dataset"
        )
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return self.dataset[i], self.dataset[i]


def collate_two_view(pairs, voxel_cap: int, point_cap: int | None = None):
    """Collate a batch of view pairs into two padded batches."""
    a = collate_batch([p[0] for p in pairs], voxel_cap, point_cap)
    b = collate_batch([p[1] for p in pairs], voxel_cap, point_cap)
    return {"view_a": a, "view_b": b}


class SSLPrefetchLoader:
    """Two-view variant of PrefetchLoader."""

    def __init__(self, dataset, batch_size: int, voxel_cap: int,
                 point_cap: int | None = None, shuffle: bool = True,
                 num_workers: int = 2, seed: int = 0):
        from .loader import PrefetchLoader

        self.two_view = TwoViewDataset(dataset)
        self.batch_size = batch_size
        self.voxel_cap = voxel_cap
        self.point_cap = point_cap
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.two_view) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.two_view))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(len(self)):
            idxs = order[i * self.batch_size : (i + 1) * self.batch_size]
            pairs = [self.two_view[j] for j in idxs]
            yield collate_two_view(pairs, self.voxel_cap, self.point_cap)
