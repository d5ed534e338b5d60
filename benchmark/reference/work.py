"""Operations and bytes of a piece of work, counted from the plan and the
widths, whatever code does it, and its roofline bound at the published peaks
of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates, at the full 700 W
power limit). A reference backbone's `pass_work` counts its pass with these.

A sparse conv over a book with P present (output, input) pairs and widths
Ci -> Co does 2 P Ci Co operations forward, as many for the input's gradient
(dX) and as many for the kernel's (dW). Its bytes, each read or written
once: forward x, W, the book (int32, one entry per output row and offset)
and the output; dX the cotangent, W, the adjoint book and dX; dW x, the
cotangent, the adjoint book and dW in float32. Activations and kernels count
at `act_bytes` (2: bf16 operands, the kernels' type whatever the caller's).
A dense 1x1 product over N rows does 2 N Ci Co operations each way.

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


def pairs(book: list) -> int:
    return int(sum(int(o.numel()) for o, _ in book))


def conv_work(p: int, k: int, ci: int, co: int, n_out: int, n_in: int, act_bytes: int = 2,
              grad: bool = False, need_dx: bool = True) -> list:
    """[(part, operations, bytes)] of one sparse conv: "fwd", and with
    `grad` "dx" (unless `need_dx` is false) and "dw"."""
    ops = 2 * p * ci * co
    w = k * ci * co * act_bytes
    out = [("fwd", ops, n_in * ci * act_bytes + w + n_out * k * 4 + n_out * co * act_bytes)]
    if grad:
        if need_dx:
            out.append(("dx", ops, n_out * co * act_bytes + w + n_in * k * 4
                        + n_in * ci * act_bytes))
        out.append(("dw", ops, (n_in * ci + n_out * co) * act_bytes + n_in * k * 4
                    + k * ci * co * 4))
    return out


def dense_ops(n: int, ci: int, co: int, grad: bool) -> int:
    return 2 * n * ci * co * (3 if grad else 1)
