"""The 90th percentile of the window's step times (the module's `step_log`
`step_ms`: two CUDA events around each step)."""

import statistics


def read(inp):
    ms = inp["step_ms"]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10)[8]
