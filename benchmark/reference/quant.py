"""Lower-precision controls: a product's operands rounded as a kernel in
that precision would take them."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude at the format's largest finite value), returned in x's type."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, returned in x's type."""
    return x.to(torch.bfloat16).to(x.dtype)


CONTROLS = {"fp8": fp8, "bf16": bf16}
