"""Known/unknown label-space construction for generalized class discovery.

Rebuild of `utils/unkn_labels.py`: compresses known train-labels into
``0..K-1`` and maps every held-out (unknown) class to the single id ``K``
(the "unknown" slot); also the percentage-balanced automatic split chooser.
"""

from __future__ import annotations

MAX_SPLIT_NUM = 4

# Split tables from the reference CLI (`main.py:87-113`): split id ->
# (unknown train-label ids, labeled-scan ratio). Split 0 is our extension:
# fully supervised, no held-out classes (the reference has no discovery
# splits for SemanticPOSS — it appears only in its oldest dataset
# generation, `utils/dataset.py:1875` — so POSS runs are supervised-only).
FULL_SUP = ([], 1.0)
KITTI_SPLITS = {0: FULL_SUP, 1: ([4, 6], 0.50), 2: ([2, 4, 5], 0.45),
                3: ([3, 6, 9], 0.40)}
NUSC_SPLITS = {0: FULL_SUP, 1: ([1, 8], 0.45), 2: ([1, 2, 5], 0.35),
               3: ([0, 4, 7, 8], 0.25)}
POSS_SPLITS = {0: FULL_SUP}
_SPLIT_TABLES = {
    "SemanticKITTI": KITTI_SPLITS,
    "nuScenes": NUSC_SPLITS,
    "SemanticPOSS": POSS_SPLITS,
}


def split_table(dataset: str, split: int):
    # unknown dataset names historically fell through to the nuScenes table
    table = _SPLIT_TABLES.get(dataset, NUSC_SPLITS)
    if split not in table:
        raise ValueError(f"unknown split {split} for {dataset}")
    return table[split]


def build_label_mapping(unknown_labels, all_labels):
    """Compress knowns to 0..K-1, unknowns to K. Returns (map, inv_map, K).

    `all_labels` is the set of train-label ids (including -1 = ignore, which
    is dropped from the returned mappings), e.g. learning_map_inv keys.
    """
    mapping: dict = {}
    inv: dict = {}
    nxt = -1
    for lab in all_labels:
        if lab not in unknown_labels:
            mapping[lab] = nxt
            inv[nxt] = lab
            nxt += 1
    for unk in unknown_labels:
        mapping[unk] = nxt
    mapping.pop(-1, None)
    inv.pop(-1, None)
    return mapping, inv, nxt


def balanced_unknown_labels(split: int, content: dict, learning_map: dict,
                            learning_map_inv: dict):
    """Pick unknown classes so each split holds roughly equal point mass.

    Mirrors `utils/unkn_labels.unknown_labels`: aggregate per-train-label point
    ratios, sort descending, chunk into MAX_SPLIT_NUM contiguous groups.
    """
    label_pct = {i: 0.0 for i in learning_map_inv.keys()}
    for raw, pct in content.items():
        label_pct[learning_map[raw]] += pct
    label_pct.pop(-1, None)
    ordered = sorted(label_pct, key=label_pct.get, reverse=True)
    per = len(ordered) // MAX_SPLIT_NUM
    sizes = [per] * MAX_SPLIT_NUM
    i = 0
    while sum(sizes) != len(ordered):
        sizes[i] += 1
        i += 1
    start = sum(sizes[:split])
    return ordered[start : start + sizes[split]]


def mapping_lut(mapping: dict, num_train_labels: int):
    """Dense LUT train-label -> compressed id for vectorized application."""
    import numpy as np

    lut = np.full(num_train_labels + 2, -1, np.int32)  # +synthetic slot margin
    for k, v in mapping.items():
        if 0 <= k <= num_train_labels + 1:
            lut[k] = v
    return lut
