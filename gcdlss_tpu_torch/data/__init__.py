"""The port's host data pipeline (numpy): the counterpart of
`gcdlss_tpu/data`, file by file and name by name."""

from .meta import dataset_meta, learning_map_lut
from .labels import build_label_mapping, balanced_unknown_labels, split_table
from .semantic_kitti import SemanticKITTIDataset, get_dataset
from .collation import collate_batch, collate_voxels, collate_points, VoxelBatchNp, PointBatchNp
from .loader import MultiprocessLoader, PrefetchLoader, cycle, make_loader
from .splits import ensure_split_file, generate_split_indices, load_split_indices
from .synthetic import (write_synthetic_kitti, synthetic_scan,
                        write_learnable_kitti, synthetic_scan_learnable,
                        synth_scan_points)
