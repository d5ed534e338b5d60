"""Reduction of a `torch.profiler` chrome trace to device time.

The busy time is the union of the device's kernel, memcpy and memset events
(the arithmetic of `gcdlss_tpu_torch/tools/stage2_split.device_summary`,
commit 7a989cf, frozen here). A kernel belongs to a host span when the
runtime call that launched it (same correlation id) started inside it.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the program's kernels by function, whatever their template arguments
OWN_KERNEL = re.compile(r"(gather_\w+|sum_slices_kernel|cube_\w+)")


def kernel_name(name: str) -> str:
    own = OWN_KERNEL.search(name)
    return own.group(1) if own else name


def union(intervals: list) -> list:
    """Merged [start, end] of the given intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(intervals: list, lo: float = float("-inf"), hi: float = float("inf")) -> float:
    """Length of the union of the intervals inside [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


class Trace:
    """The events of one chrome trace that the per-layer metrics read."""

    def __init__(self, events: list):
        self.device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.spans = defaultdict(list)  # host span name -> sorted [(start, end)]
        self.ops = []
        launch_ts = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat == "user_annotation":
                self.spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
            elif cat == "cpu_op":
                self.ops.append((e["ts"], e["ts"] + e["dur"], e["name"]))
            elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch_ts[e["args"]["correlation"]] = e["ts"]
        for v in self.spans.values():
            v.sort()
        self.launch_ts = launch_ts

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def window(self, name: str) -> tuple:
        s = self.spans[name]
        if len(s) != 1:
            raise ValueError(f"trace: {len(s)} spans {name!r}, expected 1")
        return s[0]

    def intervals(self, lo: float, hi: float) -> list:
        return [(e["ts"], e["ts"] + e["dur"]) for e in self.device
                if e["ts"] + e["dur"] > lo and e["ts"] < hi]

    def span_device_us(self, name: str) -> float:
        """Device time of the events launched inside host spans `name`."""
        spans = self.spans.get(name, [])
        starts = [s for s, _ in spans]
        total = 0.0
        for e in self.device:
            t = self.launch_ts.get(e.get("args", {}).get("correlation"))
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e["dur"]
        return total

    def by_kernel(self, lo: float, hi: float) -> dict:
        """Device microseconds of each kernel (by function), memcpy and memset
        whose event starts inside [lo, hi]."""
        out = defaultdict(float)
        for e in self.device:
            if lo <= e["ts"] < hi:
                out[kernel_name(e["name"])] += e["dur"]
        return dict(out)

    def host_at(self, t: float) -> str:
        """What the host was doing at time t: the innermost span covering t,
        else the innermost operator, else "idle host"."""
        best = None
        for name, spans in self.spans.items():
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][1] >= t:
                length = spans[i][1] - spans[i][0]
                if name != "bench/window" and (best is None or length < best[0]):
                    best = (length, name)
        if best is not None:
            return best[1]
        ops = [(e - s, n) for s, e, n in self.ops if s <= t <= e]
        return min(ops)[1] if ops else "idle host"

    def idle_gaps(self, lo: float, hi: float, top: int = 10) -> list:
        """The longest device gaps inside [lo, hi], each with what the host
        was doing when it began: [(label, seconds)]."""
        merged = union(self.intervals(lo, hi))
        edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [(self.host_at(t), dur / 1e6) for dur, t in gaps[:top]]
