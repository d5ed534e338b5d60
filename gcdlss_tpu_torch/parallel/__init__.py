"""Data parallelism of the PyTorch port over a `torch.distributed` group."""

from .mesh import make_mesh, pad_cap_for_mesh, replicate, shard_point_batch, shard_voxel_batch
