"""Device time per step of the fused batch norm (`gcdlss_tpu_torch/ops/fused_norm.py`):
the kernels launched inside the port's `norm/fwd` spans (the statistics
and the affine map with its residual, ReLU and row mask, each norm of the
three backbone passes) and `norm/bwd` spans (the sums and dx, on autograd's
thread), over the window's steps. A program that opens no such span reads
nothing."""


def read(inp):
    tr = inp.get("trace")
    if tr is None or not tr.device or not inp.get("steps") or "norm/fwd" not in tr.spans:
        return None
    return (tr.span_device_us("norm/fwd") + tr.span_device_us("norm/bwd")) / 1e3 / inp["steps"]
