"""The least time a card could take for a piece of work: the roofline bound
that the conv-parts tool and `chip_smoke.py` set beside each kernel's time."""

from __future__ import annotations

# published peaks of one H100 SXM (dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def bound_ms(min_bytes: int, flops: int, bytes_per_s: float = PEAK_BYTES_PER_S,
             flops_per_s: float = PEAK_BF16_FLOPS) -> tuple:
    """(ms, "bytes" or "operations") for work that must move `min_bytes` bytes
    (each input read once, each output written once) and do `flops` bf16-input
    operations: the larger of the two times at the given rates, and which."""
    by_bytes, by_ops = min_bytes / bytes_per_s * 1e3, flops / flops_per_s * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"
