"""Host-side (numpy) voxel quantization, mirroring the device path exactly.

Same key packing + sorted-unique semantics as `gcdlss_tpu_torch.ops.coords`,
so the host data pipeline and the in-step device re-voxelization agree
bit-for-bit. Equivalent of
`ME.utils.sparse_quantize(return_index=True, return_inverse=True)`.
numpy is the default; `native=True` asks for the C++ voxelizer
(`csrc/voxelizer.cpp`, the same result) and raises if it cannot be built.
"""

from __future__ import annotations

import numpy as np


def sparse_quantize_np(points: np.ndarray, voxel_size: float, native: bool = False):
    """Quantize [N,3] float points; returns (coords [M,3] int32 sorted,
    unique_map [M] first-occurrence indices, inverse_map [N])."""
    if native:
        from . import native_voxelizer

        return native_voxelizer.sparse_quantize(
            np.ascontiguousarray(points, np.float32), voxel_size)
    q = np.floor(points / voxel_size).astype(np.int64)
    off = 1 << 20
    key = ((q[:, 0] + off) << 42) | ((q[:, 1] + off) << 21) | (q[:, 2] + off)
    uniq, unique_map, inverse_map = np.unique(key, return_index=True, return_inverse=True)
    coords = q[unique_map].astype(np.int32)
    return coords, unique_map.astype(np.int64), inverse_map.astype(np.int64)
