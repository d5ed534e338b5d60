"""Device time per step of the kernels launched inside the step's
`discover/mining` span (candidates, k-means, the Hungarian match)."""


def read(inp):
    tr = inp.get("trace")
    if tr is None or not tr.device or not inp["steps"] or "discover/mining" not in tr.spans:
        return None
    return tr.span_device_us("discover/mining") / 1e3 / inp["steps"]
