"""The voxelizer front end in the reference's four modes (PyTorch port of
`gcdlss_tpu/models/voxelizer.py`; reference `models/voxelizer.py:27-487`):

  * 'hard': fixed max_points-per-voxel buffers (mmcv hard_voxelize);
  * 'dynamic': per-point voxel coords, no pooling (dynamic_voxelize);
  * 'cylindrical': (rho, phi, z) binning, then dynamic voxelize and a max
    scatter into the voxels;
  * 'minkunet': quantize and unique with inverse maps.
Every shape is static.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.scatter import cylindrical_coords, dynamic_scatter, dynamic_voxelize, hard_voxelize
from ..ops.voxelize import sparse_quantize


@dataclass(frozen=True)
class Voxelizer:
    voxel_type: str = "minkunet"  # hard | dynamic | cylindrical | minkunet
    voxel_size: tuple = (0.05, 0.05, 0.05)
    point_cloud_range: tuple = (-100.0, -100.0, -100.0, 100.0, 100.0, 100.0)
    max_num_points: int = 32
    max_voxels: int = 65536

    def voxelize(self, points, feats, batch_idx, valid) -> dict:
        if self.voxel_type == "hard":
            return hard_voxelize(points, feats, batch_idx, valid, self.point_cloud_range,
                                 self.voxel_size, self.max_voxels, self.max_num_points)
        if self.voxel_type == "dynamic":
            coords, in_range = dynamic_voxelize(points, batch_idx, valid,
                                                self.point_cloud_range, self.voxel_size)
            return {"coords": coords, "valid": in_range}
        if self.voxel_type == "cylindrical":
            coords, in_range = dynamic_voxelize(cylindrical_coords(points), batch_idx, valid,
                                                self.point_cloud_range, self.voxel_size)
            out = dynamic_scatter(feats, coords, in_range, self.max_voxels, "max")
            out["point_coords"] = coords
            return out
        if self.voxel_type == "minkunet":
            return sparse_quantize(points, batch_idx, valid, float(self.voxel_size[0]),
                                   self.max_voxels)
        raise ValueError(self.voxel_type)
