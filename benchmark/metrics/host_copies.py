"""Copies between host and device memory a step: the window's `Memcpy HtoD`
and `Memcpy DtoH` events of the device trace, over the window's steps. A
copy counts whether or not the host waited for it; a synchronisation that
copies nothing is not seen here (the trace's reduction, `trace.Trace`,
keeps no runtime call's name)."""

from benchmark import spans


def read(inp):
    tr = inp.get("trace")
    if tr is None or not tr.device or not inp.get("steps"):
        return None
    return spans.host_copies(tr, *inp["window_us"]) / inp["steps"]
