"""The window's model operations (counted from the benchmark's plans of the
batches the window trained on: `counts.stage2_step`) over the traced
window's time at the published bf16 dense peak."""

from benchmark import peaks


def read(inp):
    work = inp.get("work")
    if not work or not work["steps"] or "traced_window_s" not in inp:
        return None
    return 100.0 * work["model_ops"] / (inp["traced_window_s"] * peaks.PEAK_BF16_FLOPS)
