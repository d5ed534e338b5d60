"""Device-idle time per step inside the two plans: the time within the
window's `discover/plan` and `discover/mix_plan` spans in which no kernel,
memcpy or memset ran, over the window's steps. What the plans cost beyond
their device time (`plan_ms`): the host work the device waits for."""

from benchmark import spans


def read(inp):
    return spans.idle_ms_per_step(inp, ("discover/plan", "discover/mix_plan"))
