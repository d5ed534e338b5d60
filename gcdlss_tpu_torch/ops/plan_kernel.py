"""k^3 neighbor-map kernel wrapper (CUDA, `csrc/cube_map.cu`).

Replaces the TPU kernel `_kernel_v2` of `gcdlss_tpu/ops/plan_kernel.py`. Its
plain version is the join path, `plan.join_neighbor_map`, which it equals bit
for bit. The wrapper takes the plain version only for tensors on the CPU; for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .coords import pack_keys


def cube_neighbor_map(key_hi: torch.Tensor, key_lo: torch.Tensor, k1: int) -> torch.Tensor:
    """[cap, k1^3] int32 neighbor rows (-1 absent) of one level's sorted,
    unique, sentinel-padded int32 keys; offsets in `plan._offsets(k1)` order."""
    if key_hi.device.type == "cpu":
        from .plan import join_neighbor_map

        return join_neighbor_map(key_hi, key_lo, k1)
    if key_hi.device.type != "cuda":
        raise ValueError(f"cube_neighbor_map: unsupported device {key_hi.device}")
    if key_hi.dtype != torch.int32 or key_lo.dtype != torch.int32:
        raise TypeError("cube_neighbor_map: keys must be int32")
    if key_hi.shape != key_lo.shape or key_hi.dim() != 1:
        raise ValueError("cube_neighbor_map: keys must be two [cap] vectors")
    if k1 % 2 != 1:
        raise ValueError(f"cube_neighbor_map: k1 must be odd, got {k1}")
    cap = key_hi.shape[0]
    keys = pack_keys(key_hi, key_lo).contiguous()
    nbr = torch.empty((cap, k1 ** 3), dtype=torch.int32, device=key_hi.device)
    stream = torch.cuda.current_stream(key_hi.device).cuda_stream
    _build.check(_build.library().gcd_cube_map(keys.data_ptr(), nbr.data_ptr(), cap, k1, stream),
                 "cube_neighbor_map")
    cube_neighbor_map.launches += 1
    return nbr


cube_neighbor_map.launches = 0
