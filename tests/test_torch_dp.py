"""The port's data-parallel Stage-1 and Stage-2 steps (`parallel.mesh`) on the CPU.

Two processes form a gloo group through a `FileStore` under the test's
temporary directory (no TCP port). Each holds one labeled and one unlabeled
scan of the batch (`shard_voxel_batch`) and runs the step with the group;
the one-process step on the union batch (two scans a side) runs here. The
one-process step is held to the JAX package's by `test_torch_discover.py`
and `test_torch_slice.py`; this file holds the group's step to it. No JAX.

Tolerances (f32 on both sides; the group changes only the order of the
sums in batch norm, the loss means and the gradients): losses and tau
rtol 1e-5 (atol 1e-6); parameters, statistics and queue features 1e-4 of
each tensor's largest magnitude, that magnitude taken as at least 1e-3.
The floor is for the batch-norm biases that two steps move from 0 to
~1e-5: their gradient is a sum over rows that nearly cancels, and they
differ by up to 7e-4 of their own magnitude (1e-8). Measured after two
steps: the largest parameter difference 2.4e-7 (parameters up to 1.8), the
queue's 3.4e-6 (features up to 8.0), the losses' 2e-7 relative at the
first step. Counts, the queue's counts and head, plan overflow and the
candidates' global rows are exact; every rank ends with the same bits.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gcdlss_tpu_torch.data import (SemanticKITTIDataset, build_label_mapping, collate_batch,
                                   dataset_meta, split_table, write_synthetic_kitti)
from gcdlss_tpu_torch.parallel import mesh
from gcdlss_tpu_torch.train import common as tcommon
from gcdlss_tpu_torch.train import discover as td
from gcdlss_tpu_torch.train import pretrain as tpt

WORLD = 2
CAPS = (3584, 2816, 2048, 1792, 1536)  # the union's; a rank's are half
SIDE_CAP = 2048  # rows of each side's batch (two scans of ~700 voxels)
PLANES = (16, 16, 32, 32, 32, 16, 16, 16)
STEPS = 2
LOSS_KEYS = ("loss", "sup_seg", "mse", "lasermix", "calib", "thr_loss", "novel_unsup",
             "novel_sup", "ncc_unsup", "tau")
COUNT_KEYS = ("n_cand", "n_rel", "has_novel", "plan_overflow", "cand_overflow")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One CPU thread while this module's tests run (the suite runs several
    workers at once); restored when they end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, what=""):
    ref = ref.detach().float().numpy()
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                               atol=1e-4 * max(float(np.abs(ref).max(initial=0)), 1e-3),
                               err_msg=what)


def _discover_kw(unk: int, **over) -> dict:
    kw = dict(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
              unknown_label=unk, voxel_caps=CAPS, sup_voxel_cap=SIDE_CAP, mix_voxel_caps=CAPS,
              num_sup_scans=2, point_cap=1024, voxel_size=0.15, arch="MinkUNet14",
              planes=PLANES, feat_dim=PLANES[-1], cand_cap=2048, queue_slots=4,
              queue_per_slot=128, kmeans_iters=5, steps_per_epoch=1, epochs=3, warmup_epochs=1)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two labeled and two unlabeled scans, collated as the one-process
    step takes them (numpy), and the Stage-1 / Stage-2 configurations."""
    root = str(tmp_path_factory.mktemp("kitti_dp"))
    write_synthetic_kitti(root, sequences=("00",), scans_per_seq=4, num_points=900, seed=2)
    meta = dataset_meta("SemanticKITTI")
    unknown, _ = split_table("SemanticKITTI", 1)
    mapping, _, unk = build_label_mapping(unknown, meta["learning_map_inv"].keys())
    kw = dict(voxel_size=0.15, label_mapping=mapping, unknown_labels=unknown, downsampling=800,
              augment=True, split_indices=np.array([0, 1]))
    lab = SemanticKITTIDataset(root, "train", labeled=True, resize_aug=True, seed=0, **kw)
    unlab = SemanticKITTIDataset(root, "train", labeled=False, seed=1, **kw)
    sup = collate_batch([lab[0], lab[1]], SIDE_CAP)["voxel"]
    unsup = collate_batch([unlab[0], unlab[1]], SIDE_CAP)["voxel"]
    assert max(sup.num_voxels.max(), unsup.num_voxels.max()) <= SIDE_CAP // WORLD
    to_np = lambda vb: {k: np.asarray(v) for k, v in
                        tcommon.voxel_batch_to_device(vb, "cpu").items()}
    return dict(sup=to_np(sup), unsup=to_np(unsup), unk=unk)


def _tensors(vb: dict | None) -> dict | None:
    return None if vb is None else {k: torch.as_tensor(v) for k, v in vb.items()}


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _run_stage(kind: str, kw: dict, sup: dict, unsup: dict, group=None, rank=0, world=1):
    """`STEPS` steps from the state of seed 0: the one-process step
    (`group` None) or this rank's share of the group's. Returns what the
    tests compare."""
    if group is not None:
        sup = mesh.shard_voxel_batch(sup, 2, rank, world)
        unsup = unsup and mesh.shard_voxel_batch(unsup, 2, rank, world)
    out = {"metrics": []}
    if kind == "pretrain":
        cfg = tpt.PretrainConfig(**kw)
        state = tpt.create_pretrain_state(0, cfg, device="cpu")
        if group is not None:
            mesh.replicate(state.model, group=group)
        for _ in range(STEPS):
            state, m = tpt.pretrain_train_step(state, sup, cfg, group=group)
            out["metrics"].append({k: v.clone() for k, v in m.items()})
        out["model"] = _snapshot(state.model)
        return out
    cfg = td.DiscoverConfig(**kw)
    state = td.create_discover_state(0, cfg, device="cpu")
    if group is not None:
        mesh.replicate(state.student, state.teacher, state.tau, state.generator, state.queue,
                       group=group)
    for _ in range(STEPS):
        state, m = td.discover_train_step(state, sup, unsup, cfg, group=group)
        out["metrics"].append({k: v.clone() for k, v in m.items()})
    out.update(student=_snapshot(state.student), teacher=_snapshot(state.teacher),
               queue=tuple(a.clone() for a in state.queue), tau=state.tau.detach().clone())
    # each row's index in the one-process plan, and its voxel
    lcfg = td.rank_config(cfg, group)
    plan, *_ = tcommon.plan_and_gather(td._combine_batches(sup, unsup, lcfg), lcfg.voxel_caps)
    lvl0 = plan.levels[0]
    out["rows"] = (td.global_rows(lvl0, lcfg, group) if group is not None
                   else torch.arange(lvl0.valid.shape[0]))
    out["coords"], out["valid"] = lvl0.coords.clone(), lvl0.valid.clone()
    return out


def _worker(rank: int, world: int, tmp: str, kind: str, kw: dict, sup: dict, unsup: dict):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        out = _run_stage(kind, kw, _tensors(sup), _tensors(unsup), dist.group.WORLD, rank,
                         world)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _run_group(tmp, kind: str, kw: dict, sup: dict, unsup: dict) -> list:
    """The group's run: one result per rank."""
    tmp = str(tmp)
    mp.start_processes(_worker, args=(WORLD, tmp, kind, kw, sup, unsup), nprocs=WORLD,
                       start_method="spawn", join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(WORLD)]


def _assert_ranks_equal(ranks: list) -> None:
    """Every rank's parameters, statistics, queue and metrics, bit for bit."""
    a, b = ranks[0], ranks[1]
    for key in ("model", "student", "teacher"):
        for k, v in a.get(key, {}).items():
            assert torch.equal(v, b[key][k]), (key, k)
    for x, y in zip(a.get("queue", ()), b.get("queue", ())):
        assert torch.equal(x, y)
    for ma, mb in zip(a["metrics"], b["metrics"]):
        for k, v in ma.items():
            assert torch.equal(v, mb[k]), k


def test_stage1_step_over_a_group_is_the_union_step(data, tmp_path):
    kw = dict(num_labeled_classes=17, num_classes=19, unknown_label=data["unk"],
              voxel_caps=CAPS, arch="MinkUNet14", planes=PLANES, steps_per_epoch=1, epochs=3,
              warmup_epochs=1)
    one = _run_stage("pretrain", kw, _tensors(data["sup"]), None)
    ranks = _run_group(tmp_path, "pretrain", kw, data["sup"], None)
    _assert_ranks_equal(ranks)
    for m1, mg in zip(one["metrics"], ranks[0]["metrics"]):
        assert int(m1["plan_overflow"]) == int(mg["plan_overflow"]) == 0
        np.testing.assert_allclose(float(mg["loss"]), float(m1["loss"]), rtol=1e-5)
    for k, v in one["model"].items():
        _close(ranks[0]["model"][k], v, what=k)


@pytest.fixture(scope="module")
def stage2(data, tmp_path_factory):
    """`stage2(kind)`: two Stage-2 steps, one-process and over the group,
    with a candidate cap of 2048, above the candidates ("open"), or
    with 256, below them ("capped"); each run once a module."""
    runs = {}

    def run(kind: str) -> dict:
        if kind not in runs:
            kw = _discover_kw(data["unk"], **({"cand_cap": 256} if kind == "capped" else {}))
            one = _run_stage("discover", kw, _tensors(data["sup"]), _tensors(data["unsup"]))
            ranks = _run_group(tmp_path_factory.mktemp(f"dp_{kind}"), "discover", kw,
                               data["sup"], data["unsup"])
            runs[kind] = dict(kind=kind, kw=kw, one=one, ranks=ranks)
        return runs[kind]

    return run


def _check_stage2(s) -> None:
    one, ranks = s["one"], s["ranks"]
    _assert_ranks_equal(ranks)
    grp = ranks[0]
    for step, (m1, mg) in enumerate(zip(one["metrics"], grp["metrics"])):
        for k in COUNT_KEYS:
            assert int(mg[k]) == int(m1[k]), (step, k)
        assert int(m1["plan_overflow"]) == 0
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(mg[k]), float(m1[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{step} {k}")
    assert [int(m["has_novel"]) for m in one["metrics"]] == [1] * STEPS
    _close(grp["queue"][0], one["queue"][0], what="queue feats")
    for i in (1, 2):
        assert torch.equal(grp["queue"][i], one["queue"][i])
    for who in ("student", "teacher"):
        for k, v in one[who].items():
            _close(grp[who][k], v, what=f"{who} {k}")


@pytest.mark.parametrize("kind", ["open", "capped"])
def test_stage2_step_over_a_group_is_the_union_step(stage2, kind):
    """Losses, tau, counts, the queue, the student and the EMA teacher with
    their batch-norm statistics; with the candidate cap hit (`n_cand` above
    it at both steps) too."""
    s = stage2(kind)
    _check_stage2(s)
    n_cand = [int(m["n_cand"]) for m in s["one"]["metrics"]]
    cap = s["kw"]["cand_cap"]
    if kind == "capped":
        assert min(n_cand) > cap, n_cand
        assert [int(m["cand_overflow"]) for m in s["one"]["metrics"]] == [
            n - cap for n in n_cand]
    else:
        assert max(n_cand) <= cap, n_cand


def test_candidate_rows_are_the_union_plans(stage2):
    """`global_rows` gives each rank's row the index of its voxel in the
    one-process combined plan (rank r's local scans are global scans r and
    2 + r), the row the candidate hash is taken of."""
    s = stage2("open")
    one = s["one"]
    index = {tuple(c): i for i, c in enumerate(one["coords"][one["valid"]].tolist())}
    seen = 0
    for r, res in enumerate(s["ranks"]):
        c = res["coords"][res["valid"]].clone()
        c[:, 0] = torch.where(c[:, 0] < 1, r + c[:, 0], 2 + r + c[:, 0] - 1)
        want = torch.as_tensor([index[tuple(x)] for x in c.tolist()])
        assert torch.equal(res["rows"][res["valid"]], want), r
        seen += len(want)
    assert seen == len(index)


def test_shards_hold_whole_scans(data):
    """`shard_voxel_batch` / `shard_point_batch`: each rank's rows are its
    scans' rows of the batch, renumbered from 0, padded as the collation
    pads; the point rows still point at their voxels; `pad_cap_for_mesh`
    rounds up. An uneven split whose larger share exceeds a rank's capacity
    raises, for that rank only."""
    sup = _tensors(data["sup"])
    rng = np.random.default_rng(0)
    n = sup["coords"].shape[0]
    nvalid = int(sup["valid"].sum())
    n0 = int((sup["valid"] & (sup["coords"][:, 0] == 0)).sum())
    # each scan's points at its own voxels, a tenth at none (the pad value n)
    vrow = np.stack([rng.integers(0, n0, 50), rng.integers(n0, nvalid, 50)])
    vrow = torch.as_tensor(np.where(rng.random((2, 50)) < 0.9, vrow, n).astype(np.int32))
    pb = {"voxel_row": vrow, "xyz": torch.as_tensor(rng.random((2, 50, 3)).astype(np.float32))}
    assert mesh.pad_cap_for_mesh(1001, 2) == 1002 and mesh.rank_cap(1001, 2) == 501
    rows = []
    for r in range(WORLD):
        vb = mesh.shard_voxel_batch(sup, 2, r, WORLD)
        k = int(vb["valid"].sum())
        assert vb["coords"].shape[0] == SIDE_CAP // WORLD and bool(vb["valid"][:k].all())
        assert torch.equal(vb["coords"][:k, 0], torch.zeros(k, dtype=torch.int32))
        assert bool((vb["labels"][k:] == -1).all()) and bool((vb["coords"][k:] == 0).all())
        glob = vb["coords"][:k].clone()
        glob[:, 0] += r
        rows.append(glob)
        p = mesh.shard_point_batch(pb, sup, 2, r, WORLD)
        assert torch.equal(p["xyz"], pb["xyz"][r:r + 1])
        ok = pb["voxel_row"][r] < n
        assert torch.equal(p["voxel_row"][0] < SIDE_CAP // WORLD, ok)
        assert torch.equal(vb["coords"][p["voxel_row"][0][ok].long(), 1:],
                           sup["coords"][pb["voxel_row"][r][ok].long(), 1:])
    assert torch.equal(torch.cat(rows), sup["coords"][:nvalid])
    with pytest.raises(ValueError):
        mesh.shard_voxel_batch(sup, 3, 0, WORLD)
    # the valid rows alone: the batch fits its buffer, the larger scan not
    # half of it
    tight = {k: v[:nvalid] for k, v in sup.items()}
    assert n0 != nvalid - n0
    big = 0 if 2 * n0 > nvalid else 1
    for shard in (lambda r: mesh.shard_voxel_batch(tight, 2, r, WORLD),
                  lambda r: mesh.shard_point_batch(pb, tight, 2, r, WORLD)):
        with pytest.raises(ValueError, match="capacity"):
            shard(big)
        shard(1 - big)


def test_group_refusals(data):
    """Without a group the step runs as before (`rank_config` is the
    identity); over one, the variants the group step does not run and scans
    that do not split raise before any collective."""
    cfg = td.DiscoverConfig(**_discover_kw(data["unk"]))
    assert td.rank_config(cfg, None) is cfg
    for bad in (dict(mix_mode="feature"), dict(mix_plan_mode="point"),
                dict(assigner="sinkhorn"), dict(use_lion=True), dict(num_sup_scans=3)):
        with pytest.raises(ValueError):
            td.rank_config(dataclasses.replace(cfg, **bad), _FakeGroup())
    with pytest.raises(RuntimeError):
        mesh.make_mesh()


class _FakeGroup:
    """A stand-in group of `WORLD` ranks for the checks made before any
    collective."""


@pytest.fixture(autouse=True)
def _fake_world_size(monkeypatch):
    real = mesh.world_size
    monkeypatch.setattr(mesh, "world_size",
                        lambda g: WORLD if isinstance(g, _FakeGroup) else real(g))
    monkeypatch.setattr(td, "world_size", mesh.world_size)
