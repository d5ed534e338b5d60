"""Weights from the seed: every parameter drawn on the device from one
generator in one call, in float32 (the type the model keeps them in), and
scaled by its layer's initialisation (He-normal for sparse kernels, fan-out;
LeCun-normal for dense ones; batch norm 1 and 0; biases 0)."""

from __future__ import annotations

import torch


def make(spec: dict, seed: int, device) -> tuple:
    """(params, stats): dicts of name -> tensor, per a reference backbone's
    `spec` (`reference/__init__.py`)."""
    normal = [(k, shape, init[1]) for k, (shape, init) in spec.items() if init[0] == "normal"]
    total = sum(torch.Size(shape).numel() for _, shape, _ in normal)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=g, device=device)
    params, stats, off = {}, {}, 0
    for k, shape, std in normal:
        n = torch.Size(shape).numel()
        params[k] = (z[off:off + n] * std).reshape(shape)
        off += n
    for k, (shape, init) in spec.items():
        if init[0] == "const":
            params[k] = torch.full(shape, init[1], device=device)
        elif init[0] == "stat":
            stats[k] = torch.full(shape, init[1], device=device)
    return params, stats
