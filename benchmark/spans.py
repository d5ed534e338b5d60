"""Arithmetic over the program's named spans in a `trace.Trace`, for the
readers of the spans the program opens (`gcdlss_tpu_torch.utils.logging.span`:
`step`, `step/*`, `loader/get`, `plan/*`, `conv/*`, beside `discover/*`).
Each function returns None where the trace holds none of what it reads, as
the trace of a program that opens no such span does."""

from __future__ import annotations

import bisect

from . import trace as trace_mod

# the four passes of the backbone and the conv spans inside them
PASSES = ("discover/teacher", "discover/student_main_fwd", "discover/student_mix_fwd",
          "discover/backward")
CONVS = ("conv/fwd", "conv/bwd")
# copies between host and device memory, by the device trace's event names
HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def _steps(inp) -> int:
    return inp.get("steps") or 0


def spans_in(tr, name: str, lo: float, hi: float) -> list:
    """The spans `name` that start inside [lo, hi]."""
    return [s for s in tr.spans.get(name, ()) if lo <= s[0] <= hi]


def ms_per_step(inp, name: str):
    """The summed length of the window's spans `name`, a step, in ms."""
    tr = inp.get("trace")
    if tr is None or not _steps(inp):
        return None
    found = spans_in(tr, name, *inp["window_us"])
    if not found:
        return None
    return sum(e - s for s, e in found) / 1e3 / _steps(inp)


def idle_inside_us(tr, names, lo: float, hi: float) -> float:
    """Device-idle microseconds (no kernel, memcpy or memset) inside the
    window's spans of `names`."""
    busy = trace_mod.union(tr.intervals(lo, hi))
    starts = [s for s, _ in busy]
    idle = 0.0
    for name in names:
        for s, e in spans_in(tr, name, lo, hi):
            covered = 0.0
            i = max(bisect.bisect_right(starts, s) - 1, 0)
            while i < len(busy) and busy[i][0] < e:
                covered += max(0.0, min(busy[i][1], e) - max(busy[i][0], s))
                i += 1
            idle += (e - s) - covered
    return idle


def idle_ms_per_step(inp, names):
    tr = inp.get("trace")
    if tr is None or not tr.device or not _steps(inp):
        return None
    lo, hi = inp["window_us"]
    if not any(spans_in(tr, n, lo, hi) for n in names):
        return None
    return idle_inside_us(tr, names, lo, hi) / 1e3 / _steps(inp)


def host_copies(tr, lo: float, hi: float) -> int:
    """Copies between host and device that start inside [lo, hi]."""
    return sum(1 for e in tr.device
               if e.get("cat") == "gpu_memcpy" and lo <= e["ts"] < hi
               and e["name"].startswith(HOST_COPIES))


def glue_us(tr) -> float:
    """Device time launched inside the four passes, less that launched inside
    the conv spans."""
    return (sum(tr.span_device_us(p) for p in PASSES)
            - sum(tr.span_device_us(c) for c in CONVS))
