"""The sparse convs' share of their roofline: the sum over the window's
convs of the least time their work needs (`counts.conv_work`, at the
published peaks) over the device time of the kernels that run them today
(K1 `gather_gemm_kernel`, K2's `gather_dw_kernel*` and `sum_slices_kernel`)."""

CONV_KERNELS = ("gather_gemm_kernel", "gather_dw_kernel", "sum_slices_kernel")


def read(inp):
    tr, work = inp.get("trace"), inp.get("work")
    if tr is None or not work or not work["steps"]:
        return None
    lo, hi = inp["window_us"]
    us = sum(t for name, t in tr.by_kernel(lo, hi).items() if name.startswith(CONV_KERNELS))
    if us <= 0:
        return None
    return 100.0 * work["conv_bound_ms"] / (us / 1e3)
