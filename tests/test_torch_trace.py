"""The port's tracing on the CPU: the span helper, the spans and counters of
a Stage-2 step, and the host loop that takes the batches.

A tiny Stage-2 module (MinkUNet14, narrow planes, caps of 1,024 rows) trains
on a synthetic SemanticKITTI tree through its own loaders. Under
`torch.profiler` its chrome trace holds the spans the benchmark's readers
look for (`benchmark/metrics/`); the counters beside them are plain integers
on the functions that do the work.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from gcdlss_tpu_torch.data import (SemanticKITTIDataset, build_label_mapping, dataset_meta,
                                   split_table, write_synthetic_kitti)
from gcdlss_tpu_torch.models.layers import SparseBatchNorm
from gcdlss_tpu_torch.ops.fused_conv import PoolConvFn, SubmConvFn
from gcdlss_tpu_torch.train import common
from gcdlss_tpu_torch.train.discover import DiscoverConfig
from gcdlss_tpu_torch.train.modules import ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive
from gcdlss_tpu_torch.utils import logging as tlog

CAPS = (1024, 768, 512, 256, 256)
PLANES = (8, 8, 8, 8, 8, 8, 8, 8)
PASSES = ("discover/teacher", "discover/student_main_fwd", "discover/student_mix_fwd",
          "discover/backward")
VOXEL_FIELDS = ("coords", "feats", "labels", "mapped_labels", "valid", "point_ids")
POINT_FIELDS = ("xyz", "feats", "labels", "mapped_labels", "valid", "voxel_row")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One CPU thread for the port while this module's tests run: the suite
    runs several workers at once. The pool's size is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_trace"))
    write_synthetic_kitti(root, sequences=("00",), scans_per_seq=4, num_points=500, seed=4)
    unknown, _ = split_table("SemanticKITTI", 1)
    mapping, inv, unk = build_label_mapping(
        unknown, dataset_meta("SemanticKITTI")["learning_map_inv"].keys())
    cfg = DiscoverConfig(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                         unknown_label=unk, voxel_caps=CAPS, sup_voxel_cap=512,
                         mix_voxel_caps=CAPS, num_sup_scans=1, point_cap=400, voxel_size=0.15,
                         arch="MinkUNet14", planes=PLANES, feat_dim=PLANES[-1], cand_cap=128,
                         queue_slots=2, queue_per_slot=32, kmeans_iters=3, steps_per_epoch=4)
    kw = dict(voxel_size=0.15, label_mapping=mapping, unknown_labels=unknown, downsampling=400,
              augment=True, split_indices=np.array([0, 1]))
    lab = SemanticKITTIDataset(root, "train", labeled=True, seed=0, **kw)
    unlab = SemanticKITTIDataset(root, "train", labeled=False, seed=1, **kw)

    def module():
        return ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive(cfg, mapping, inv, seed=0,
                                                              device="cpu")

    return dict(cfg=cfg, lab=lab, unlab=unlab, module=module)


def _kept(it, into):
    for item in it:
        into.append(item)
        yield item


def _spans(trace_file) -> dict:
    """Host span name -> sorted [(start, end)] of a chrome trace."""
    out = {}
    for e in json.loads(trace_file.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return {k: sorted(v) for k, v in out.items()}


def _inside(span, spans) -> bool:
    return any(s <= span[0] and span[1] <= e for s, e in spans)


def test_span_is_one_null_context_while_no_profiler_records(monkeypatch):
    calls = []
    monkeypatch.setattr(tlog, "record_function", lambda name: calls.append(name) or name)
    off = {id(tlog.span(n)) for n in ("step", "conv/fwd", "plan/maps") * 3}
    assert off == {id(tlog._NO_SPAN)} and calls == []
    with tlog.span("step"), tlog.span("step"):  # reentrant, and reusable
        pass
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tlog.span("step/read") == "step/read"
    assert calls == ["step/read"]


def test_stage2_steps_record_their_spans_and_counters(setup, tmp_path, monkeypatch):
    """Two steps of `train_epoch` under the profiler: each of the step's
    spans once a step (`loader/get` once a loader, `step/fetch` once more for
    the take that ends the pass), the plan's spans in both plans, one
    `conv/fwd` a conv forward (counted at the Functions' `apply`) and one
    `conv/bwd` a student conv's backward, every conv span inside one of the
    four passes; one `norm/fwd` a batch norm in each of the three forward
    passes and one `norm/bwd` a norm in each student backward, inside the
    passes and outside the conv spans; the counters of the batches' bytes
    and of the loaders' takes."""
    applied = []
    for fn in (SubmConvFn, PoolConvFn):
        def counted(*args, _apply=fn.apply):
            applied.append(1)
            return _apply(*args)

        monkeypatch.setattr(fn, "apply", counted)
    exp = setup["module"]()
    lab_loader, unlab_loader = exp.make_loaders(setup["lab"], setup["unlab"], num_workers=1)
    labs, unlabs = [], []
    vbytes0 = common.voxel_batch_to_device.bytes
    pbytes0 = common.point_batch_to_device.bytes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        exp.train_epoch(itertools.islice(_kept(lab_loader, labs), 2),
                        _kept(unlab_loader, unlabs))
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    spans = _spans(trace)
    count = {k: len(v) for k, v in spans.items()}

    steps = len(exp.step_log)
    assert steps == 2 and len(labs) == len(unlabs) == 2
    for name in ("step", "step/to_device", "step/read", "plan/gather", "discover/plan",
                 "discover/mix_plan", *PASSES):
        assert count.get(name) == steps, name
    assert count["step/fetch"] == steps + 1
    assert count["loader/get"] == 2 * steps
    levels = len(CAPS)
    assert (count["plan/unique"], count["plan/maps"], count["plan/pool"]) == (
        2 * steps, 2 * steps * levels, 2 * steps * (levels - 1))
    for plan in ("discover/plan", "discover/mix_plan"):
        inner = [s for s in spans["plan/maps"] if _inside(s, spans[plan])]
        assert len(inner) == steps * levels, plan
    assert count["conv/fwd"] == len(applied) > 0
    # the teacher's pass has no backward; the two student passes run the same convs
    assert 3 * count["conv/bwd"] == 2 * count["conv/fwd"]
    passes = [s for p in PASSES for s in spans[p]]
    assert all(_inside(s, passes) for s in spans["conv/fwd"] + spans["conv/bwd"])
    norms = sum(isinstance(m, SparseBatchNorm) for m in exp.state.student.modules())
    assert norms == 30  # MinkUNet14: bn0, bn1-4, bntr4-7, two a block, five projections
    assert (count["norm/fwd"], count["norm/bwd"]) == (3 * norms * steps, 2 * norms * steps)
    norm_spans = spans["norm/fwd"] + spans["norm/bwd"]
    convs = spans["conv/fwd"] + spans["conv/bwd"]
    assert all(_inside(s, passes) and not _inside(s, convs) for s in norm_spans)
    for a, b in zip(spans["step/fetch"][:steps], spans["step"]):
        assert a[1] <= b[0]  # the fetch lies outside the step it feeds

    vb = [b["voxel"] for b in labs + unlabs]
    pb = [b["points"] for b in labs + unlabs]
    assert common.voxel_batch_to_device.bytes - vbytes0 == sum(
        getattr(v, f).nbytes for v in vb for f in VOXEL_FIELDS if getattr(v, f, None) is not None)
    assert common.point_batch_to_device.bytes - pbytes0 == sum(
        getattr(p, f).nbytes for p in pb for f in POINT_FIELDS)
    assert lab_loader.taken == unlab_loader.taken == steps
    assert 0 <= lab_loader.empty_takes <= steps


class _Side:
    """An iterator of `n` batches that logs each take, the one that finds it
    ended too."""

    def __init__(self, name, n, log):
        self.name, self.n, self.log = name, n, log

    def __iter__(self):
        return self

    def __next__(self):
        self.log.append(self.name)
        if not self.n:
            raise StopIteration
        self.n -= 1
        return 1


def test_train_epoch_is_the_zip_loop_and_stops_on_the_labeled_side(setup):
    """The explicit loop trains on the pairs `zip` made, to the same
    metrics, and takes in `zip`'s order: the labeled batch first, and no
    unlabeled one once the labeled side has ended."""
    lab_loader, unlab_loader = setup["module"]().make_loaders(setup["lab"], setup["unlab"],
                                                              num_workers=1)
    labs = list(itertools.islice(lab_loader, 2))
    unlabs = list(itertools.islice(unlab_loader, 2))
    loop, old = setup["module"](), setup["module"]()
    loop.train_epoch(labs, unlabs)
    for sup, unsup in zip(labs, unlabs):  # the loop `train_epoch` had
        old.train_step(sup, unsup)
    assert len(loop.step_log) == len(old.step_log) == 2

    def metrics(rec):
        return {k: v for k, v in rec.items() if k not in ("seconds", "step_ms")}

    assert [metrics(r) for r in loop.step_log] == [metrics(r) for r in old.step_log]

    stub = setup["module"]()
    stub.train_step = lambda sup, unsup: {"loss": float(sup + unsup)}
    for n_lab, n_unlab, order, steps in ((1, 3, "LUL", 1), (3, 1, "LULU", 1),
                                         (2, 2, "LULUL", 2), (0, 2, "L", 0)):
        log = []
        out = stub.train_epoch(_Side("L", n_lab, log), _Side("U", n_unlab, log))
        assert "".join(log) == order, (n_lab, n_unlab)
        assert out == ({"loss": 2.0} if steps else {})
