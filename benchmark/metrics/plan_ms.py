"""Device time per step of the kernels launched inside the step's
`discover/plan` span (the combined plan and its gathers)."""


def read(inp):
    tr = inp.get("trace")
    if tr is None or not tr.device or not inp["steps"] or "discover/plan" not in tr.spans:
        return None
    return tr.span_device_us("discover/plan") / 1e3 / inp["steps"]
