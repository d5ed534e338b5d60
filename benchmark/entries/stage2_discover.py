"""Cell driver for Stage-2 discovery training of `gcdlss_tpu_torch`.

What a user runs, as the port's CLI does: `ExpMergeDiscover...NCCAdaptive`
and its `train_epoch` over the labeled and unlabeled `PrefetchLoader`s of
`make_loaders`, on SemanticKITTI datasets of a synthetic tree that set-up
writes under TMPDIR.

The configuration's `reference_model` names the backbone's plain reference
(`reference.backbone`): its leaves give the weights, its forward the
reference's passes, its `pass_work` the traced run's work counts.

Set-up builds the one module, gives it the benchmark's weights (drawn from
the seed on the device), starts the loaders once, and drives the first
`checked_steps` steps through `train_epoch` on the loaders' feed: they
compile and warm every shape, and they are the steps the reference follows.
Meanwhile it records what the program's mining of each of them took and
gave (`mining_seam`) and the queue around it; the seam is taken away before
the window.
The window then calls `train_epoch` once more on the same iterators, the
labeled one cut when the window's time is up; it ends when `train_epoch`
returns. Once it has closed and the module is freed, the reference works the
checked steps out again from the raw files and the seed, and `compare`
judges the module's loss, first gradient and change; the reference's mining
and queue push, run on the candidates and the queue the program's mining
had, judge what it gave (`mining_check`).
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import compare, counts, scans, weights
from ..reference import backbone
from ..reference import data as ref_data
from ..reference import sparse as ref_sparse
from ..reference import stage2 as ref_stage2


class Feed:
    """A loader iterator, timed: each `next` adds its wait. `take(n)` hands
    out n batches; `until(t)` hands out batches while the clock is before t;
    `each()` hands them out for as long as asked. `keep` keeps the batches
    handed out."""

    def __init__(self, it):
        self.it, self.waits, self.kept, self.keep, self.voxels = it, [], [], False, []

    def _next(self):
        t = time.perf_counter()
        with torch.profiler.record_function("bench/loader"):
            item = next(self.it)
        self.waits.append(time.perf_counter() - t)
        self.voxels.append(int(item["voxel"].valid.sum()))
        if self.keep:
            self.kept.append(item)
        return item

    def take(self, n):
        for _ in range(n):
            yield self._next()

    def until(self, deadline):
        while time.perf_counter() < deadline:
            yield self._next()

    def each(self):
        while True:
            yield self._next()


# the module's settings the driver sets itself; the others come from the files
EXPLICIT = {"num_labeled_classes", "num_unlabeled_classes", "num_classes", "unknown_label",
            "voxel_caps", "sup_voxel_cap", "mix_voxel_caps", "num_sup_scans", "point_cap"}


def run_config(config: dict, traffic: dict) -> dict:
    """The flat settings both sides run by: the configuration's, the
    traffic's, and the label space of the split."""
    space = ref_data.label_space(config["unknown_train_labels"])
    cfg = {**config, **traffic, "num_known": space["num_known"],
           "num_novel": space["num_novel"], "unknown_label": space["unknown_label"],
           "caps": tuple(config["voxel_caps"]), "mix_caps": tuple(config["mix_voxel_caps"])}
    cfg["scans_per_side"] = traffic["scans_per_side"]
    return cfg


def make_tree(root: Path, cfg: dict, seed: int) -> dict:
    """The scan files of each side, in dataset order: the first half of the
    distinct scans labeled, the rest unlabeled, each list repeated."""
    files = scans.write_tree(root, np.random.default_rng([seed, 7]), cfg["distinct_scans"],
                             cfg["points_per_scan"])
    half = cfg["distinct_scans"] // 2
    lab, unlab = files[:half] * cfg["repeat"], files[half:] * cfg["repeat"]
    return {"root": str(root), "labeled": lab, "unlabeled": unlab, "split": list(range(half))}


def seeds(seed: int) -> dict:
    s = int(seed) & ((1 << 62) - 1)
    return {"model": s, "weights": s + 1, "tree": s, "labeled": s + 2, "unlabeled": s + 3}


def _program(cfg: dict, tree: dict, sd: dict, device):
    """The module, its datasets and its loaders, as the CLI makes them."""
    from gcdlss_tpu_torch.data import SemanticKITTIDataset, build_label_mapping, dataset_meta
    from gcdlss_tpu_torch.train.discover import DiscoverConfig
    from gcdlss_tpu_torch.train.modules import ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive

    unknown = cfg["unknown_train_labels"]
    mapping, inv, unk = build_label_mapping(
        unknown, dataset_meta(cfg["dataset"])["learning_map_inv"].keys())
    if unk != cfg["unknown_label"]:
        raise ValueError(f"unknown slot {unk} != the reference's {cfg['unknown_label']}")
    fields = set(DiscoverConfig.__dataclass_fields__)
    dcfg = DiscoverConfig(
        num_labeled_classes=cfg["num_known"], num_unlabeled_classes=cfg["num_novel"],
        num_classes=cfg["num_known"] + cfg["num_novel"], unknown_label=unk,
        voxel_caps=cfg["caps"], sup_voxel_cap=cfg["sup_voxel_cap"],
        mix_voxel_caps=cfg["mix_caps"], num_sup_scans=cfg["scans_per_side"],
        point_cap=cfg["downsampling"],
        **{k: tuple(cfg[k]) if k == "planes" else cfg[k] for k in fields - EXPLICIT if k in cfg})
    module = ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive(dcfg, mapping, inv,
                                                            seed=sd["model"], device=device)
    common = dict(voxel_size=cfg["voxel_size"], downsampling=cfg["downsampling"], augment=True,
                  label_mapping=mapping, unknown_labels=unknown)
    split = np.array(tree["split"])
    lab = SemanticKITTIDataset(tree["root"], "train", split_indices=split, labeled=True,
                               resize_aug=True, seed=sd["labeled"], **common)
    unlab = SemanticKITTIDataset(tree["root"], "train", split_indices=split, labeled=False,
                                 seed=sd["unlabeled"], **common)
    for ds, files in ((lab, tree["labeled"]), (unlab, tree["unlabeled"])):
        # the index list repeats the distinct scans: no pass ends in the window
        ds.scan_files = [s for s, _ in files]
        ds.label_files = [lf for _, lf in files]
        ds.num_files = len(files)
    workers = min(cfg["num_workers"], os.cpu_count() or 1)
    return module, module.make_loaders(lab, unlab, num_workers=workers), workers


def _state_norms(module) -> dict:
    st = module.state
    student = {k: v for k, v in st.student.state_dict().items()}
    teacher = {k: v for k, v in st.teacher.state_dict().items()}
    return {"params": {**{k: student[k] for k, _ in st.student.named_parameters()},
                       "tau": st.tau},
            "teacher": {k: teacher[k] for k, _ in st.teacher.named_parameters()},
            "stats": {**{f"student.{k}": v for k, v in student.items() if "running_" in k},
                      **{f"teacher.{k}": v for k, v in teacher.items() if "running_" in k}}}


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _queue(module) -> tuple:
    q = module.state.queue
    return _cpu(q.feats), _cpu(q.counts), int(q.head)


@contextlib.contextmanager
def mining_seam(log: list):
    """Records each mining the program runs while open: the inputs of its
    `train.discover._assign_kmeans_hungarian` (the candidates' features and
    their mask and count, the queue's rows, the initial-row scores, the known
    and novel heads) and what it returned (the reliable candidates, their
    count, the novel gate, each candidate's novel class)."""
    from gcdlss_tpu_torch.train import discover

    real = discover._assign_kmeans_hungarian

    def seam(cfg, heads, cand_feats, cand_valid, n_cand, qfeats, qvalid, scores):
        out = real(cfg, heads, cand_feats, cand_valid, n_cand, qfeats, qvalid, scores)
        log.append({"cand_feats": _cpu(cand_feats), "cand_valid": _cpu(cand_valid),
                    "n_cand": int(n_cand), "qfeats": _cpu(qfeats), "qvalid": _cpu(qvalid),
                    "scores": _cpu(scores),
                    "heads": {h: (_cpu(getattr(heads, h).kernel), _cpu(getattr(heads, h).bias))
                              for h in ("final", "final3")},
                    "rel": _cpu(out[0]), "n_rel": int(out[1]), "has_novel": bool(out[2]),
                    "mapped": _cpu(out[3])})
        return out

    discover._assign_kmeans_hungarian = seam
    try:
        yield
    finally:
        discover._assign_kmeans_hungarian = real


def mining_check(cfg: dict, log: list, device) -> dict:
    """The program's mining and queue push of each checked step, each judged
    by the reference's run on what the program's stage took. `mining_gap`:
    the worst step's share of the candidates either side keeps as reliable
    that the two sides keep or label differently (1 where the novel gate
    differs); `queue_gap`: entries of the queues after the checked steps
    that differ from the reference's push of the program's reliable
    candidates into the queue before each."""
    worst, queue_bad = 0.0, 0
    with torch.no_grad():
        for rec in log:
            d = {k: v.to(device) for k, v in rec.items() if isinstance(v, torch.Tensor)}
            heads = {h: (w.to(device), b.to(device)) for h, (w, b) in rec["heads"].items()}
            ref = ref_stage2.mine(d["cand_feats"], d["cand_valid"], rec["n_cand"], d["qfeats"],
                                  d["qvalid"], d["scores"], heads, cfg)
            rel_p = d["rel"]
            if ref["has_novel"] != rec["has_novel"]:
                gap = 1.0
            else:
                both = rel_p | ref["rel"]
                differ = (rel_p != ref["rel"]) | (rel_p & (d["mapped"] != ref["mapped"]))
                gap = int(differ.sum()) / max(int(both.sum()), 1)
            worst = max(worst, gap)
            feats, counts, head = rec["queue_before"]
            if rec["has_novel"]:
                feats, counts, head = ref_stage2.push(feats, counts.long(), head,
                                                      rec["cand_feats"], rec["rel"])
            pf, pc, ph = rec["queue_after"]
            queue_bad += int((pf != feats).sum()) + int((pc.long() != counts.long()).sum())
            queue_bad += int(ph != head)
    return {"mining_gap": worst, "queue_gap": queue_bad}


def spin_ms(n: int = 200_000) -> float:
    """Milliseconds of a fixed loop of Python additions on this thread: how
    fast the host runs the main thread's Python at this moment, beside the
    load average, which a sandboxed kernel may read as 0."""
    t = time.perf_counter()
    x = 0
    for i in range(n):
        x += i
    return 1e3 * (time.perf_counter() - t)


def run(cfg: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        workdir: Path) -> dict:
    """One run of the cell. Returns the end-to-end values, the per-layer
    inputs, the compared numbers and the device facts."""
    sd = seeds(seed)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    spec = backbone(cfg["reference_model"]).spec(cfg)
    phases = {"imports": time.perf_counter() - t_start}
    with tempfile.TemporaryDirectory(prefix="bench-tree-") as tmp:
        tree = make_tree(Path(tmp), cfg, sd["tree"])
        phases["tree"] = time.perf_counter() - t_start
        module, (lab_loader, unlab_loader), workers = _program(cfg, tree, sd, device)
        phases["module"] = time.perf_counter() - t_start
        params0, stats0 = weights.make(spec, sd["weights"], device)
        sdict = module.state.student.state_dict()
        if set(sdict) != set(params0) | set(stats0) or any(
                tuple(sdict[k].shape) != tuple(v.shape) for k, v in {**params0, **stats0}.items()):
            raise ValueError("the program's model does not have the configuration's leaves")
        for m in (module.state.student, module.state.teacher):
            m.load_state_dict({**params0, **stats0})
        module.state.step = cfg["start_step"]
        init = {k: v.detach().clone() for k, v in _state_norms(module)["params"].items()}
        init_stats = {k: v.detach().clone() for k, v in _state_norms(module)["stats"].items()}
        lab, unlab = Feed(iter(lab_loader)), Feed(iter(unlab_loader))
        lab.keep = unlab.keep = True
        phases["weights"] = time.perf_counter() - t_start
        prog, mining = {}, []
        for i in range(cfg["checked_steps"]):
            before = _queue(module)
            with mining_seam(mining):
                module.train_epoch(lab.take(1), unlab.take(1))
            if len(mining) != i + 1:
                raise ValueError("the program's step did not mine through its k-means seam")
            mining[i].update(queue_before=before, queue_after=_queue(module))
            if i == 0:
                opt = module.state.optimizer
                named = {**dict(module.state.student.named_parameters()), "tau": module.state.tau}
                prog["grad"] = compare.leaf_norms(
                    {k: opt.state[p]["momentum_buffer"] for k, p in named.items()
                     if "momentum_buffer" in opt.state.get(p, {})})
                prog["stats1"] = compare.deltas(_state_norms(module)["stats"], init_stats)
        prog["terms"] = [dict(rec) for rec in module.step_log]
        prog["n_cand"] = [rec["n_cand"] for rec in module.step_log]
        now = _state_norms(module)
        prog["change"] = {
            "student": compare.deltas(now["params"], init),
            "teacher": compare.deltas(now["teacher"], {k: init[k] for k in now["teacher"]}),
            "stats": compare.deltas(now["stats"], init_stats)}
        checked_batches = list(zip(lab.kept, unlab.kept))
        lab.keep = unlab.keep = trace  # the traced run keeps the window's batches to count them
        lab.kept, unlab.kept = [], []
        del init, now
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        phases["checked_steps"] = setup_s

        # ---- the window ----
        n_before = len(module.step_log)
        w_lab, w_unlab = len(lab.waits), len(unlab.waits)
        setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.__enter__()
        load_start, spin_start = os.getloadavg(), spin_ms()
        cpu_start = time.process_time()
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench/window"):
            module.train_epoch(lab.until(t0 + seconds), unlab.each())
            if on_card:
                torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        host = {"window_cpu_s": time.process_time() - cpu_start, "load_start": load_start,
                "load_end": os.getloadavg(), "spin_ms": [spin_start, spin_ms()]}
        if prof is not None:
            prof.__exit__(None, None, None)
        window_peak = torch.cuda.max_memory_allocated() if on_card else 0
        process_peak = max(setup_peak, window_peak)
        steps = module.step_log[n_before:]
        waits = [a + b for a, b in zip(lab.waits[w_lab:], unlab.waits[w_unlab:])]
        voxels = [a + b for a, b in zip(lab.voxels[w_lab:], unlab.voxels[w_unlab:])]
        window_batches = list(zip(lab.kept, unlab.kept))
        trace_file = None
        if prof is not None:
            trace_file = workdir / "window_trace.json"
            prof.export_chrome_trace(str(trace_file))
            del prof
        from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
        from gcdlss_tpu_torch.ops.plan_kernel import cube_neighbor_map

        launches = {"K1": gather_gemm.launches, "K2": gather_gemm_backward.launches,
                    "K3": cube_neighbor_map.launches}
        del module, lab, unlab, lab_loader, unlab_loader
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # ---- after the window: the reference, then the counts ----
        ref, loader_mismatch = reference_side(cfg, tree, sd, device, params0, stats0,
                                              checked_batches)
        nums = compare.numbers(prog, ref)
        nums.update(mining_check(cfg, mining, device), loader_mismatch=loader_mismatch)
        del mining
        work = None
        if trace:
            work = window_work(cfg, window_batches, sd, device)
    losses = [s["loss"] for s in steps]
    return {
        "setup_s": setup_s, "window_s": window_s, "steps": len(steps),
        "scans": len(steps) * 2 * cfg["scans_per_side"],
        "failed": sum(1 for x in losses if not math.isfinite(x)),
        "window_peak_bytes": window_peak, "memory_peak_bytes": process_peak,
        "step_ms": [s["step_ms"] for s in steps], "loader_wait_s": waits, "voxels": voxels,
        "step_metrics": {k: [s[k] for s in steps] for k in ("n_cand", "n_rel", "has_novel",
                                                            "plan_overflow")},
        "launches": launches, "workers": workers, "host": host, "trace_file": trace_file,
        "work": work,
        "numbers": nums, "program": prog, "reference": ref, "setup_phases": phases}


def _side(cfg, tree, sd, labeled):
    space = ref_data.label_space(cfg["unknown_train_labels"])
    files = tree["labeled" if labeled else "unlabeled"]
    return ref_data.Side([s for s, _ in files], [lf for _, lf in files],
                         sd["labeled" if labeled else "unlabeled"], labeled,
                         cfg["loader_seeds"][0 if labeled else 1], space, cfg["voxel_size"],
                         cfg["downsampling"])


def _mismatch(batch, ref: dict) -> int:
    """Entries of the loader's batch that differ from the reference's."""
    vb, pb = batch["voxel"], batch["points"]
    pairs = [(vb.coords, ref["coords"]), (vb.feats, ref["feats"]), (vb.labels, ref["labels"]),
             (vb.mapped_labels, ref["mapped_labels"]), (vb.valid, ref["valid"]),
             (pb.xyz, ref["xyz"]), (pb.feats, ref["point_feats"]),
             (pb.labels, ref["point_labels"]), (pb.mapped_labels, ref["point_mapped"]),
             (pb.valid, ref["point_valid"]), (pb.voxel_row, ref["voxel_row"])]
    bad = 0
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        bad += int(a.size) if a.shape != b.shape else int((a != b).sum())
    return bad


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def reference_side(cfg, tree, sd, device, params0, stats0, program_batches, quant=None,
                   drop_half: bool = False):
    """The reference's checked steps from the raw files and the seeds:
    (its numbers for `compare`, entries of the program's batches that differ
    from its own)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        n = cfg["checked_steps"]
        S = cfg["scans_per_side"]
        sides = [ref_data.batches(_side(cfg, tree, sd, lab), n, S, cap, cfg["downsampling"])
                 for lab, cap in ((True, cfg["sup_voxel_cap"]),
                                  (False, cfg["caps"][0] - cfg["sup_voxel_cap"]))]
        mismatch = sum(_mismatch(pb, rb) for (pl, pu), rl, ru in
                       zip(program_batches, *sides) for pb, rb in ((pl, rl), (pu, ru)))
        step = ref_stage2.Stage2(backbone(cfg["reference_model"]), cfg, params0, stats0,
                                 sd["model"], device, quant)
        init = {**{k: v.detach().clone() for k, v in step.params.items()},
                "tau": step.tau.detach().clone()}
        init_stats = {**{f"student.{k}": v.clone() for k, v in step.stats.items()},
                      **{f"teacher.{k}": v.clone() for k, v in step.teacher_stats.items()}}
        out = {"n_cand": [], "terms": []}
        for i, (sup, unsup) in enumerate(zip(*sides)):
            rec = step.step(_to_device(sup, device), _to_device(unsup, device), drop_half)
            out["n_cand"].append(rec["n_cand"])
            out["terms"].append(rec)
            if i == 0:
                out["grad"] = compare.leaf_norms(step.buf)
                out["stats1"] = compare.deltas(
                    {**{f"student.{k}": v for k, v in step.stats.items()},
                     **{f"teacher.{k}": v for k, v in step.teacher_stats.items()}}, init_stats)
        after = {**step.params, "tau": step.tau}
        stats = {**{f"student.{k}": v for k, v in step.stats.items()},
                 **{f"teacher.{k}": v for k, v in step.teacher_stats.items()}}
        out["change"] = {"student": compare.deltas(after, init),
                         "teacher": compare.deltas(step.teacher,
                                                   {k: init[k] for k in step.teacher}),
                         "stats": compare.deltas(stats, init_stats)}
        del step
        return out, mismatch
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def plans_of(cfg: dict, sup: dict, unsup: dict, num_areas: int, device):
    """The benchmark's own (combined, mixed) plans of one step's batches."""
    S = cfg["scans_per_side"]

    def rows(side, shift):
        v = torch.as_tensor(side.valid, device=device)
        c = torch.as_tensor(side.coords, device=device)[v].to(torch.int64)
        c[:, 0] += shift
        return c

    cs, cu = rows(sup, 0), rows(unsup, S)
    coords0 = torch.cat([cs, cu])
    is_sup = torch.arange(coords0.shape[0], device=device) < cs.shape[0]
    plan = ref_sparse.Plan(coords0, cfg["caps"])
    center = (coords0[:, 1:4].to(torch.float32) + 0.5) * cfg["voxel_size"]
    par = ref_stage2.band_parity(center, torch.tensor(num_areas, device=device))
    b = coords0[:, 0]
    pair = torch.where(is_sup, b, b - S)
    in1 = torch.where(is_sup, par == 0, par == 1)
    mcoords = torch.cat([torch.where(in1, pair, S + pair)[:, None], coords0[:, 1:]], 1)
    mix = ref_sparse.Plan(mcoords[torch.argsort(ref_sparse.pack(mcoords))], cfg["mix_caps"])
    return plan, mix


def window_work(cfg: dict, batches: list, sd: dict, device) -> dict:
    """Model operations and conv bounds of the window's steps, counted from
    the benchmark's plans of the batches the window trained on. The mixed
    plan's band count is the step's draw, replayed from the seed."""
    pass_work = backbone(cfg["reference_model"]).pass_work
    g = torch.Generator(device=device).manual_seed(sd["model"])
    n = cfg["cand_cap"] + cfg["queue_slots"] * cfg["queue_per_slot"]
    for _ in range(cfg["checked_steps"]):
        torch.randint(len(ref_stage2.NUM_AREAS), (), generator=g, device=device)
        torch.rand(n, generator=g, device=device)
    total = {"model_ops": 0, "conv_ops": 0, "conv_bound_ms": 0.0}
    with torch.no_grad():
        for sup, unsup in batches:
            pick = int(torch.randint(len(ref_stage2.NUM_AREAS), (), generator=g, device=device))
            torch.rand(n, generator=g, device=device)
            plan, mix = plans_of(cfg, sup["voxel"], unsup["voxel"],
                                 ref_stage2.NUM_AREAS[pick], device)
            for k, v in counts.stage2_step(plan, mix, cfg, pass_work).items():
                total[k] += v
    total["steps"] = len(batches)
    return total


def per_layer_inputs(res: dict, cfg: dict) -> dict:
    """What the per-layer metric readers read."""
    from .. import trace as trace_mod

    out = {"cfg": cfg, **{k: res[k] for k in ("window_s", "steps", "step_ms", "loader_wait_s",
                                               "work", "launches")}}
    if res["trace_file"] is not None:
        tr = trace_mod.Trace.load(res["trace_file"])
        lo, hi = tr.window("bench/window")
        out["trace"] = tr
        out["window_us"] = (lo, hi)
        out["busy_s"] = trace_mod.busy_us(tr.intervals(lo, hi), lo, hi) / 1e6
        out["traced_window_s"] = (hi - lo) / 1e6
        os.remove(res["trace_file"])
    return out


def end_to_end(res: dict, cfg: dict) -> dict:
    return {"scans_per_s": res["scans"] / res["window_s"],
            "peak_mem_gib": res["window_peak_bytes"] / 2 ** 30, "setup_s": res["setup_s"]}


def summary(res: dict) -> str:
    return json.dumps({"steps": res["steps"], "window_s": res["window_s"],
                       "loader_workers": res["workers"], "launches": res["launches"],
                       "step_metrics": res["step_metrics"],
                       "program_loss": [t["loss"] for t in res["program"]["terms"]],
                       "reference_loss": [t["loss"] for t in res["reference"]["terms"]],
                       "program_n_cand": res["program"]["n_cand"],
                       "reference_n_cand": res["reference"]["n_cand"],
                       "step_ms": [round(x, 1) for x in res["step_ms"]],
                       "loader_wait_ms": [round(1e3 * x, 1) for x in res["loader_wait_s"]],
                       "voxels_a_step": res["voxels"], "setup_s": res["setup_s"],
                       "setup_phases_s": res["setup_phases"],
                       "host_load_start": res["host"]["load_start"],
                       "host_load_end": res["host"]["load_end"],
                       "host_spin_ms": res["host"]["spin_ms"],
                       "window_cpu_s": res["host"]["window_cpu_s"]})


def control(cfg: dict, seed: int, device, quant=None, drop_half: bool = False) -> dict:
    """The compared numbers with the reference, made worse, put in the
    program's place: computed through `quant` (the lower-precision control)
    or leaving out half of each side's scans (a fault)."""
    sd = seeds(seed)
    with tempfile.TemporaryDirectory(prefix="bench-tree-") as tmp:
        tree = make_tree(Path(tmp), cfg, sd["tree"])
        params0, stats0 = weights.make(backbone(cfg["reference_model"]).spec(cfg),
                                       sd["weights"], device)
        ref, _ = reference_side(cfg, tree, sd, device, params0, stats0, [])
        bad, _ = reference_side(cfg, tree, sd, device, params0, stats0, [], quant, drop_half)
    nums = compare.numbers(bad, ref)
    nums["loader_mismatch"] = 0
    return nums
