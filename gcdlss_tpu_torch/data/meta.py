"""Dataset metadata: label spaces, learning maps, colors, class frequencies.

This is factual dataset metadata (standard SemanticKITTI / nuScenes-lidarseg
label taxonomy), mirroring the keys of the reference's YAML configs
(`config/semkitti_minkunet.yaml`, `config/nuscenes_minkunet.yaml`) so that the
split tables and eval protocols line up exactly.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- SemanticKITTI

KITTI_LABELS = {
    0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus",
    15: "motorcycle", 16: "on-rails", 18: "truck", 20: "other-vehicle",
    30: "person", 31: "bicyclist", 32: "motorcyclist", 40: "road",
    44: "parking", 48: "sidewalk", 49: "other-ground", 50: "building",
    51: "fence", 52: "other-structure", 60: "lane-marking", 70: "vegetation",
    71: "trunk", 72: "terrain", 80: "pole", 81: "traffic-sign",
    99: "other-object", 252: "moving-car", 253: "moving-bicyclist",
    254: "moving-person", 255: "moving-motorcyclist", 256: "moving-on-rails",
    257: "moving-bus", 258: "moving-truck", 259: "moving-other-vehicle",
}

KITTI_LEARNING_MAP = {
    0: -1, 1: -1, 10: 0, 11: 1, 13: 4, 15: 2, 16: 4, 18: 3, 20: 4, 30: 5,
    31: 6, 32: 7, 40: 8, 44: 9, 48: 10, 49: 11, 50: 12, 51: 13, 52: -1,
    60: 8, 70: 14, 71: 15, 72: 16, 80: 17, 81: 18, 99: -1, 252: 0, 253: 6,
    254: 5, 255: 7, 256: 4, 257: 4, 258: 3, 259: 4,
}

KITTI_LEARNING_MAP_INV = {
    -1: 0, 0: 10, 1: 11, 2: 15, 3: 18, 4: 20, 5: 30, 6: 31, 7: 32, 8: 40,
    9: 44, 10: 48, 11: 49, 12: 50, 13: 51, 14: 70, 15: 71, 16: 72, 17: 80,
    18: 81,
}

KITTI_COLOR_MAP = {  # BGR, keyed by raw label id
    0: [0, 0, 0], 1: [0, 0, 255], 10: [245, 150, 100], 11: [245, 230, 100],
    13: [250, 80, 100], 15: [150, 60, 30], 16: [255, 0, 0],
    18: [180, 30, 80], 20: [255, 0, 0], 30: [30, 30, 255],
    31: [200, 40, 255], 32: [90, 30, 150], 40: [255, 0, 255],
    44: [255, 150, 255], 48: [75, 0, 75], 49: [75, 0, 175],
    50: [0, 200, 255], 51: [50, 120, 255], 52: [0, 150, 255],
    60: [170, 255, 150], 70: [0, 175, 0], 71: [0, 60, 135],
    72: [80, 240, 150], 80: [150, 240, 255], 81: [0, 0, 255],
    99: [255, 255, 50], 252: [245, 150, 100], 253: [200, 40, 255],
    254: [30, 30, 255], 255: [90, 30, 150], 256: [255, 0, 0],
    257: [250, 80, 100], 258: [180, 30, 80], 259: [255, 0, 0],
}

# per-class point-count ratios (dataset statistics; used by the
# percentage-balanced automatic split maker, reference utils/unkn_labels.py:3-24)
KITTI_CONTENT = {
    0: 0.018889854628292943, 1: 0.0002937197336781505, 10: 0.040818519255974316,
    11: 0.00016609538710764618, 13: 2.7879693665067774e-05,
    15: 0.00039838616015114444, 16: 0.0, 18: 0.0020633612104619787,
    20: 0.0016218197275284021, 30: 0.00017698551338515307,
    31: 1.1065903904919655e-08, 32: 5.532951952459828e-09,
    40: 0.1987493871255525, 44: 0.014717169549888214, 48: 0.14392298360372,
    49: 0.0039048553037472045, 50: 0.1326861944777486, 51: 0.0723592229456223,
    52: 0.002395131480328884, 60: 4.7084144280367186e-05,
    70: 0.26681502148037506, 71: 0.006035012012626033, 72: 0.07814222006271769,
    80: 0.002855498193863172, 81: 0.0006155958086189918,
    99: 0.009923127583046915, 252: 0.001789309418528068,
    253: 0.00012709999297008662, 254: 0.00016059776092534436,
    255: 3.745553104802113e-05, 256: 0.0, 257: 0.00011351574470342043,
    258: 0.00010157861367183268, 259: 4.3840131989471124e-05,
}

KITTI_SPLIT_SEQUENCES = {
    "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
    "valid": ["08"],
    "test": ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"],
}

# -------------------------------------------------------------------- nuScenes

NUSC_LABELS_16 = {
    0: "noise", 1: "barrier", 2: "bicycle", 3: "bus", 4: "car",
    5: "construction_vehicle", 6: "motorcycle", 7: "pedestrian",
    8: "traffic_cone", 9: "trailer", 10: "truck", 11: "driveable_surface",
    12: "other_flat", 13: "sidewalk", 14: "terrain", 15: "manmade",
    16: "vegetation",
}

NUSC_LEARNING_MAP = {
    1: -1, 5: -1, 7: -1, 8: -1, 10: -1, 11: -1, 13: -1, 19: -1, 20: -1,
    0: -1, 29: -1, 31: -1, 9: 0, 14: 1, 15: 2, 16: 2, 17: 3, 18: 4, 21: 5,
    2: 6, 3: 6, 4: 6, 6: 6, 12: 7, 22: 8, 23: 9, 24: 10, 25: 11, 26: 12,
    27: 13, 28: 14, 30: 15,
}

NUSC_LEARNING_MAP_INV = {
    -1: 0, 0: 9, 1: 14, 2: 16, 3: 17, 4: 18, 5: 21, 6: 2, 7: 12, 8: 22,
    9: 23, 10: 24, 11: 25, 12: 26, 13: 27, 14: 28, 15: 30,
}

NUSC_COLOR_MAP = {
    0: [0, 0, 255], 1: [255, 0, 0], 2: [255, 128, 0], 3: [0, 255, 0],
    4: [0, 128, 255], 5: [255, 0, 255], 6: [153, 0, 153], 7: [0, 255, 255],
    8: [128, 0, 255], 9: [0, 102, 204], 10: [128, 128, 128],
    11: [128, 64, 0], 12: [192, 192, 0], 13: [0, 128, 128], 14: [0, 0, 128],
    15: [0, 100, 0], 16: [0, 175, 0],
}


# ---------------------------------------------------------------- SemanticPOSS

POSS_LABELS = {
    0: "unlabeled", 4: "person", 5: "2+ person", 6: "rider", 7: "car",
    8: "trunk", 9: "plants", 10: "traffic sign", 11: "traffic sign 2",
    12: "traffic sign 3", 13: "pole", 14: "trashcan", 15: "building",
    16: "cone-stone", 17: "fence", 21: "bike", 22: "other-ground",
}

POSS_LEARNING_MAP = {
    0: -1, 1: -1, 2: -1, 3: -1, 4: 0, 5: 0, 6: 1, 7: 2, 8: 3, 9: 4, 10: 5,
    11: 5, 12: 5, 13: 6, 14: 7, 15: 8, 16: 9, 17: 10, 18: -1, 19: -1,
    20: -1, 21: 11, 22: 12,
}

POSS_LEARNING_MAP_INV = {
    -1: 0, 0: 4, 1: 6, 2: 7, 3: 8, 4: 9, 5: 10, 6: 13, 7: 14, 8: 15, 9: 16,
    10: 17, 11: 21, 12: 22,
}

POSS_SPLIT_SEQUENCES = {
    "train": ["00", "01", "02", "04", "05"],
    "valid": ["03"],
    "test": [],
}

POSS_COLOR_MAP = {
    0: [0, 0, 0], 4: [30, 30, 255], 5: [30, 30, 200], 6: [200, 40, 255],
    7: [245, 150, 100], 8: [0, 60, 135], 9: [0, 175, 0], 10: [150, 240, 255],
    11: [150, 200, 255], 12: [150, 160, 255], 13: [150, 240, 255],
    14: [125, 255, 0], 15: [0, 200, 255], 16: [255, 150, 255],
    17: [50, 120, 255], 21: [245, 230, 100], 22: [75, 0, 175],
}


def dataset_meta(name: str) -> dict:
    if name == "SemanticKITTI":
        return {
            "labels": KITTI_LABELS,
            "learning_map": KITTI_LEARNING_MAP,
            "learning_map_inv": KITTI_LEARNING_MAP_INV,
            "color_map": KITTI_COLOR_MAP,
            "content": KITTI_CONTENT,
            "split_sequence": KITTI_SPLIT_SEQUENCES,
            "folder_name": {"input": "velodyne", "label": "labels"},
            "num_classes": 19,
        }
    if name == "nuScenes":
        inv = NUSC_LEARNING_MAP_INV
        # labels keyed by raw id -> name, built from the 16-class taxonomy
        raw_labels = {inv[k]: NUSC_LABELS_16[k + 1] for k in range(16)}
        raw_labels[0] = "noise"
        return {
            "labels": raw_labels,
            "learning_map": NUSC_LEARNING_MAP,
            "learning_map_inv": NUSC_LEARNING_MAP_INV,
            "color_map": NUSC_COLOR_MAP,
            "content": None,
            "split_sequence": None,
            "folder_name": None,
            "num_classes": 16,
        }
    if name == "SemanticPOSS":
        return {
            "labels": POSS_LABELS,
            "learning_map": POSS_LEARNING_MAP,
            "learning_map_inv": POSS_LEARNING_MAP_INV,
            "color_map": POSS_COLOR_MAP,
            "content": None,
            "split_sequence": POSS_SPLIT_SEQUENCES,
            "folder_name": {"input": "velodyne", "label": "labels"},
            "num_classes": 13,
        }
    raise NameError(f"Dataset {name} not implemented")


def learning_map_lut(learning_map: dict, max_raw: int = 260) -> np.ndarray:
    """Vectorizable raw-label -> train-label lookup table (-1 = ignore)."""
    lut = np.full(max_raw + 1, -1, np.int32)
    for k, v in learning_map.items():
        lut[k] = v
    return lut
