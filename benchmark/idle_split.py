"""One traced run of a cell, as `run.py --trace 1` makes it, with what the
breakdown's ten longest gaps leave out:

    python3 benchmark/idle_split.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout, on a machine with the cell's CUDA device. It
prints `run.py`'s result line, then one line `idle_split: {...}` with

  - every idle gap of the window (`trace.Trace.idle_gaps`, all of them, each
    put down to what the host was doing where it began) summed by label; the
    share of the window's idle time so put down to a program span (any span
    but the harness's `bench/*`), and to the bare `step` span, where no child
    span is open; the window's first gap, which begins with it;
  - the conv spans (`conv/fwd`, `conv/bwd`) of the window outside the four
    passes (`spans.PASSES`): 0 when every conv runs inside a pass;
  - over the window's steps: the conv forwards (`conv/fwd` spans) beside
    K1's launches, and the program's counters: the batches' bytes copied
    host to device, the loaders' takes and those that found the queue
    empty. A program without a counter reads null there.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def counters(loaders: list) -> dict:
    from gcdlss_tpu_torch.ops import fused_conv
    from gcdlss_tpu_torch.train import common

    def get(obj, name):
        return getattr(obj, name, None)

    h2d = [get(common.voxel_batch_to_device, "bytes"), get(common.point_batch_to_device, "bytes")]
    takes = [(get(ld, "taken"), get(ld, "empty_takes")) for ld in loaders]
    return {"k1_launches": fused_conv.gather_gemm.launches,
            "h2d_bytes": None if None in h2d else sum(h2d),
            "taken": None if not takes or None in takes[0] else sum(t for t, _ in takes),
            "empty_takes": None if not takes or None in takes[0] else sum(e for _, e in takes)}


def per_step(before: dict, after: dict, steps: int) -> dict:
    return {k: None if after[k] is None or not steps else (after[k] - before[k]) / steps
            for k in after}


def idle_by_label(tr, lo: float, hi: float) -> dict:
    """Idle seconds of the window by what the host was doing where each gap
    began (the breakdown's `idle_gaps`, every gap), and the first gap."""
    from benchmark import trace

    by = defaultdict(float)
    for label, s in tr.idle_gaps(lo, hi, top=None):
        by[label] += s
    first = trace.union(tr.intervals(lo, hi))
    first = first[0][0] if first else hi
    return {"by_label_s": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "idle_s": sum(by.values()),
            "first_gap_ms": [[tr.host_at(lo), (first - lo) / 1e3]] if first > lo else []}


def conv_spans_outside_passes(tr, lo: float, hi: float) -> int:
    from benchmark import spans

    passes = [s for p in spans.PASSES for s in spans.spans_in(tr, p, lo, hi)]
    return sum(1 for c in spans.CONVS for s, e in spans.spans_in(tr, c, lo, hi)
               if not any(a <= s and e <= b for a, b in passes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run, spans

    run.set_caches()
    c = run.cell(run.load_spec(), args.workload)
    import torch

    from gcdlss_tpu_torch.train import modules

    cls = modules.ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive
    loaders, snaps = [], []
    make_loaders, train_epoch = cls.make_loaders, cls.train_epoch

    def keep_loaders(self, *a, **kw):
        out = make_loaders(self, *a, **kw)
        loaders.extend(out)
        return out

    def snap_epoch(self, *a, **kw):
        snaps.append(counters(loaders))
        return train_epoch(self, *a, **kw)

    cls.make_loaders, cls.train_epoch = keep_loaders, snap_epoch
    try:
        out = run.measure(c, args.seed, args.seconds, True, torch.device("cuda", 0), T_START)
    finally:
        cls.make_loaders, cls.train_epoch = make_loaders, train_epoch
    inp, res = out["inputs"], out["run"]
    tr, (lo, hi) = inp["trace"], inp["window_us"]
    idle = idle_by_label(tr, lo, hi)
    program = sum(s for k, s in idle["by_label_s"].items()
                  if k in tr.spans and not k.startswith("bench/"))
    result = dict(out["result"], breakdown=run.breakdown(inp))
    print(json.dumps(result), flush=True)
    summary = {
        "card": run.power_limit(), "steps": res["steps"], "window_s": res["window_s"],
        "scans_per_s": res["scans"] / res["window_s"], **idle,
        "program_span_share": program / idle["idle_s"],
        "bare_step_share": idle["by_label_s"].get("step", 0.0) / idle["idle_s"],
        "conv_spans_outside_passes": conv_spans_outside_passes(tr, lo, hi),
        "span_counts": {n: len(tr.spans[n]) for n in sorted(tr.spans)},
        "conv_fwd_per_step": len(spans.spans_in(tr, "conv/fwd", lo, hi)) / res["steps"],
        "per_step": per_step(snaps[-1], counters(loaders), res["steps"]),
        "process_totals": counters(loaders)}
    print("idle_split: " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
