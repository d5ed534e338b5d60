"""Share of the traced window in which no kernel, memcpy or memset ran on
the device (the union of the trace's device events)."""


def read(inp):
    if not inp.get("busy_s") or inp["traced_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - inp["busy_s"] / inp["traced_window_s"])
