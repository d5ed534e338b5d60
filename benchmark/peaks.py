"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates,
at the full 700 W power limit) and the roofline bound of a piece of work.

`bound_ms` is a frozen copy of `gcdlss_tpu_torch/utils/roofline.bound_ms`
(commit 7a989cf), the arithmetic `chip_smoke.bound()` uses.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_BF16_FLOPS = 989e12  # dense bf16 / fp16 tensor-core rate


def bound_ms(min_bytes: float, flops: float, bytes_per_s: float = PEAK_BYTES_PER_S,
             flops_per_s: float = PEAK_BF16_FLOPS) -> tuple:
    """(ms, "bytes" or "operations") for work that must move `min_bytes` bytes
    (each input read once, each output written once) and do `flops` bf16-input
    operations: the larger of the two times at the given rates, and which."""
    by_bytes, by_ops = min_bytes / bytes_per_s * 1e3, flops / flops_per_s * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"
