"""Stage-2 step time and its split on one CUDA device.

Run from the repository root:

    python -m gcdlss_tpu_torch.tools.stage2_split [--trace build/stage2_step_trace.json]

At `chip_smoke.py`'s Stage-2 configuration (the `bench.py` one: MinkUNet34,
bf16, 2 labeled + 2 unlabeled synthetic 80k-point scans, cap0 = 276,480),
on voxel buffers made once on the card, it prints:

  - the step time with K3 maps (`plan_kernel=2`) and K4 maps (`plan_kernel=1`),
    after 3 warm-up steps, in 3 interleaved rounds 2/1/1/2 (host clock around
    a step that ends reading its metrics), and the peak memory;
  - each `record_function` span of the step, with the card synchronized
    around every span (5 steps, medians);
  - the student's fwd+bwd on the combined and on the mixed plan alone (one CE
    loss each), the teacher forward alone, and `plan_and_gather` per route;
  - one step under `torch.profiler`: the device time summed over the trace's
    kernel, memcpy and memset events, the busy time (their union) and the
    idle share of the step's host wall time, and the kernels by device time
    (the port's own kernels summed over their template instances).
    The trace is written to `--trace`;
  - the Stage-1 step (`pretrain_train_step`, MinkUNet34, the labeled side's 2
    scans, cap0 = 138,240): median of 5 after 2 warm-ups, peak memory, and one
    step under the profiler, summarised the same way.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import statistics
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def log(*args):
    print(*args, flush=True)


def synthetic_sides(device):
    """(sup, unsup) voxel buffers as the Stage-2 loaders hand them over:
    random labels of the 17 known classes and random features on valid rows,
    unlabeled batch indices starting at 0."""
    import numpy as np

    import chip_smoke as cs

    coords, valid = cs.voxel_batch(np.random.default_rng(5), device, sides=2)
    g = torch.Generator(device=device).manual_seed(0)

    def side(sl):
        c, v = coords[sl].clone(), valid[sl]
        n = c.shape[0]
        lab = torch.where(v, torch.randint(0, 17, (n,), device=device, generator=g), -1).int()
        return {"coords": c, "feats": torch.rand(n, 1, device=device, generator=g) * v[:, None],
                "labels": lab, "mapped_labels": lab, "valid": v}

    sup = side(slice(0, cs.CAP0))
    unsup = side(slice(cs.CAP0, cs.S2_CAP0))
    unsup["coords"][:, 0] -= cs.BATCH
    unsup["coords"] = torch.where(unsup["valid"][:, None], unsup["coords"], 0)
    return sup, unsup


OWN_KERNEL = re.compile(r"(gather_\w+|sum_slices_kernel|cube_\w+)")


def device_summary(trace: Path, wall_ms: float) -> None:
    """Sum the device events of a chrome trace; their union is the busy time.
    The port's kernels are listed by function, whatever their template
    arguments."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    total = sum(e["dur"] for e in events) / 1e3
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        s, t = e["ts"], e["ts"] + e["dur"]
        if t > end:
            busy += t - max(s, end)
            end = t
    busy /= 1e3
    log(f"profiled step: wall {wall_ms:.1f} ms; device events {len(events)}, "
        f"summed {total:.1f} ms, busy (union) {busy:.1f} ms, idle share "
        f"{1 - busy / wall_ms:.4f} of the wall")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        own = OWN_KERNEL.search(e["name"])
        name = own.group(1) if own else e["name"]
        by_name[name][0] += e["dur"] / 1e3
        by_name[name][1] += 1
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  {ms:9.2f} ms {100 * ms / total:5.1f}%  n={n:5d}  {name[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path, default=Path("build/stage2_step_trace.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage2_split: no CUDA device")

    import chip_smoke as cs
    from gcdlss_tpu_torch.losses import cross_entropy
    from gcdlss_tpu_torch.models.minkunet import DEFAULT_PLANES, assemble_dummy_logits
    from gcdlss_tpu_torch.train import discover as td
    from gcdlss_tpu_torch.train.common import default_caps, plan_and_gather

    torch.backends.cuda.matmul.allow_tf32 = False
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    caps = default_caps(cs.S2_CAP0)
    sup, unsup = synthetic_sides(dev)
    cfgs = {pk: td.DiscoverConfig(
        num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19, unknown_label=17,
        voxel_caps=caps, sup_voxel_cap=cs.CAP0, mix_voxel_caps=caps, num_sup_scans=cs.BATCH,
        point_cap=cs.POINTS_PER_SCAN, voxel_size=cs.VOXEL_SIZE, arch="MinkUNet34",
        planes=DEFAULT_PLANES, dtype="bfloat16", cand_cap=4096, queue_slots=20,
        queue_per_slot=1024, kmeans_iters=15, steps_per_epoch=1000, plan_kernel=pk)
        for pk in (2, 1)}
    state = td.create_discover_state(0, cfgs[2], device=dev)

    def steps(pk, n):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, m = td.discover_train_step(state, sup, unsup, cfgs[pk])
            m = {k: float(v) for k, v in m.items()}
            ts.append((time.perf_counter() - t) * 1e3)
        return ts, m

    torch.cuda.reset_peak_memory_stats()
    ts, m = steps(2, 3)
    log(f"warm-up steps ms {[round(t, 1) for t in ts]}; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    log("metrics of the last", json.dumps(m))
    res = defaultdict(list)
    for _ in range(3):
        for pk in (2, 1, 1, 2):
            res[pk] += steps(pk, 1)[0]
    for pk, ts in res.items():
        log(f"step ms plan_kernel={pk}: median {statistics.median(ts):.1f} "
            f"all {[round(t, 1) for t in ts]}")

    spans = defaultdict(list)

    @contextlib.contextmanager
    def timed(name):
        torch.cuda.synchronize()
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        spans[name].append((time.perf_counter() - t) * 1e3)

    record_function, torch.profiler.record_function = torch.profiler.record_function, timed
    try:
        ts, _ = steps(2, 5)
    finally:
        torch.profiler.record_function = record_function
    log(f"step ms with synchronized spans: median {statistics.median(ts):.1f}")
    for name, v in spans.items():
        log(f"  span {name}: median {statistics.median(v):.2f} ms")

    def med_ms(fn, n=5):
        fn()
        v = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            v.append((time.perf_counter() - t) * 1e3)
        return statistics.median(v)

    cb = td._combine_batches(sup, unsup, cfgs[2])
    plan, feats0, _, mapped0 = plan_and_gather(cb, caps, 2)
    is_sup = (plan.rep < cs.CAP0) & plan.levels[0].valid
    mix_plan, mix_feats, mix_labels = td._mixed_plan_voxel(
        cfgs[2], plan, feats0, mapped0, is_sup, torch.full_like(mapped0, -1),
        torch.tensor(4, device=dev))
    student = state.student

    def fwd_bwd(p, f, labels):
        out = student(p, f)
        cross_entropy(assemble_dummy_logits(out), labels, p.levels[0].valid).backward()

    log(f"student fwd+bwd alone, combined plan: {med_ms(lambda: fwd_bwd(plan, feats0, mapped0)):.1f} ms")
    log(f"student fwd+bwd alone, mixed plan: "
        f"{med_ms(lambda: fwd_bwd(mix_plan, mix_feats, mix_labels.clamp(min=0))):.1f} ms")
    student.zero_grad(set_to_none=True)
    with torch.no_grad():
        log(f"teacher forward alone: {med_ms(lambda: state.teacher(plan, feats0)):.1f} ms")
    for pk in (2, 1):
        log(f"plan_and_gather plan_kernel={pk}: "
            f"{med_ms(lambda: plan_and_gather(cb, caps, pk)):.2f} ms")

    from torch.profiler import ProfilerActivity, profile

    def profiled(step, trace: Path) -> None:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        device_summary(trace, wall)

    log("Stage 2:")
    profiled(lambda: td.discover_train_step(state, sup, unsup, cfgs[2]), args.trace)

    from gcdlss_tpu_torch.train import pretrain as tp

    del state, student, plan, mix_plan
    pcfg = tp.PretrainConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                             voxel_caps=default_caps(cs.CAP0), arch="MinkUNet34",
                             planes=DEFAULT_PLANES, dtype="bfloat16", steps_per_epoch=1000,
                             epochs=50)
    pstate = tp.create_pretrain_state(0, pcfg, device=dev)

    def stage1_step():
        float(tp.pretrain_train_step(pstate, sup, pcfg)[1]["loss"])

    stage1_step()
    torch.cuda.reset_peak_memory_stats()
    log(f"Stage 1: step median {med_ms(stage1_step):.1f} ms; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    profiled(stage1_step, args.trace.with_name("stage1_step_trace.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
