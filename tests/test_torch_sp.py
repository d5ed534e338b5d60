"""PyTorch port vs JAX package: voxel sharding (`parallel.voxel_shard`,
`parallel.sp_step`, `parallel.sp_discover`) on the CPU.

The ranks are gloo processes over CPU tensors, started as
`tests/test_torch_dp.py` starts them (spawn, a `FileStore` under a temporary
directory, one torch thread a rank), one spawn per world size with every
case of that world inside it: world 8 (the halo window and fold, the
sharded convs and batch-norm statistics), world 2 (the sharded Stage-1
and Stage-2 steps), world 4 (the dp 2 x sp 2 Stage-1 step). The JAX side
runs on the CPU under `tests/conftest.py`'s 8 virtual devices: the
primitives live on small arrays, as `tests/test_voxel_sp.py` runs them; the
steps against frozen goldens (`tests/torch_sp_goldens.npz`), since their
`shard_map` compiles take minutes. The `slow` test
`test_sp_goldens_are_the_jax_package` rebuilds them
(`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sp.py <scratch dir>`).

Inputs, numpy from seeds: the fixture of `tests/test_voxel_sp.py` (two
synthetic 1000-point scans at 0.5 m, caps (2048, 1664, 1168, 744, 408):
51-row blocks at level 4 at world 8, where pool halos take several hops)
for the primitives and Stage 1; Stage 2 at `tests/test_torch_dp.py`'s
configuration (two + two synthetic KITTI scans at 0.15 m, caps (3584, 2816,
2048, 1792, 1536), MinkUNet14). At `tests/test_torch_discover.py`'s caps
those scans overflow the levels (~1,200 voxels dropped) and the L2 -> L3
pool halo (~300 rows) exceeds a 256-row block, which a 2-way ring cannot
reach: both packages raise there. The weights are drawn with numpy and
carried into each model as the JAX package's trees (`utils.weights`).

Tolerances: integers (halos, windows, folds on integer payloads, remapped
books, overflow counts, counts) bit for bit. Floats, f32 on both sides,
sums in another order: the convs' outputs and dX CONV_TOL, dW DW_TOL of the
reference's largest magnitude; batch-norm statistics BN_TOL (the port's
two-pass variance against JAX's one-pass E[x^2] - E[x]^2); the steps'
losses and tau LOSS_RTOL (atol LOSS_ATOL), parameters, statistics and queue
features STATE_TOL of each tensor's largest magnitude (at least 1e-3), the
tolerances of `tests/test_torch_dp.py`; against the goldens (their norm
and 32 values) the same STATE_TOL. Ranks end with the same bits.
"""

import dataclasses
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gcdlss_tpu_torch.data import synth_scan_points
from gcdlss_tpu_torch.ops import conv as pconv
from gcdlss_tpu_torch.ops.fused_conv import pool_conv, subm_conv
from gcdlss_tpu_torch.ops.plan import build_unet_plan
from gcdlss_tpu_torch.parallel import sp_discover, sp_step
from gcdlss_tpu_torch.parallel import voxel_shard as vs
from gcdlss_tpu_torch.train import common as tcommon
from gcdlss_tpu_torch.train import discover as td
from gcdlss_tpu_torch.train import pretrain as tpt
from gcdlss_tpu_torch.utils.weights import (load_jax_discover_state, load_jax_params,
                                            state_dict_to_jax)

GOLDENS = Path(__file__).with_name("torch_sp_goldens.npz")
CAPS = (2048, 1664, 1168, 744, 408)  # tests/test_voxel_sp.py's
S2_CAPS = (3584, 2816, 2048, 1792, 1536)  # tests/test_torch_dp.py's union caps
S2_SIDE = 2048
S2_PLANES = (16, 16, 32, 32, 32, 16, 16, 16)
CONV_TOL = 1e-5
DW_TOL = 1e-4
BN_TOL = 1e-5
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
STATE_TOL = 1e-4
LOSS_KEYS = ("loss", "sup_seg", "mse", "lasermix", "calib", "thr_loss", "novel_unsup",
             "novel_sup", "ncc_unsup", "tau")
COUNT_KEYS = ("n_cand", "n_rel", "has_novel", "plan_overflow", "cand_overflow", "sp_overflow")
# (level, halo) of the window/fold cases at world 8: slabs on 256-row
# blocks, on 51-row blocks a slab of one block, 2 and 3 hops
WINDOWS = ((0, 5), (0, 256), (4, 51), (4, 60), (4, 153))
TOO_FAR = (4, 154)  # 4 hops: past the 3 a ring of 8 allows
# pool edge -> its halo in the conv cases at world 8: edge 0 at its
# required halo (a slab), edge 3 at 60 rows of 51-row coarse blocks (2 hops;
# it requires 33)
POOL_HALOS = {0: None, 3: 60}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One CPU thread while this module's tests run (the suite runs several
    workers at once); restored when they end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ inputs


def _batch() -> dict:
    """tests/test_voxel_sp.py's fixture (numpy): two scans, unique voxels."""
    rng = np.random.default_rng(7)
    rows = []
    for s in range(2):
        c = np.unique(np.floor(synth_scan_points(rng, 1000) / 0.5).astype(np.int32), axis=0)
        rows.append(np.concatenate([np.full((len(c), 1), s, np.int32), c], axis=1))
    coords = np.concatenate(rows)
    n = coords.shape[0]
    full = np.zeros((CAPS[0], 4), np.int32)
    full[:n] = coords
    valid = np.arange(CAPS[0]) < n
    labels = np.where(valid, rng.integers(0, 17, CAPS[0]), -1).astype(np.int32)
    return {"coords": full, "feats": rng.uniform(0, 1, (CAPS[0], 1)).astype(np.float32),
            "labels": labels, "mapped_labels": labels, "valid": valid}


def _groups(b: dict) -> list:
    """The batch's two scans as dp groups at half the caps, each scan 0."""
    out = []
    for s in range(2):
        sel = b["valid"] & (b["coords"][:, 0] == s)
        n = int(sel.sum())
        g = {}
        for k, v in b.items():
            buf = np.full((CAPS[0] // 2, *v.shape[1:]), -1 if "labels" in k else 0, v.dtype)
            buf[:n] = v[sel]
            g[k] = buf
        g["coords"][:, 0] = 0
        out.append(g)
    return out


def _stage2_batches(root: str):
    """Two labeled and two unlabeled synthetic KITTI scans (numpy voxel
    dicts, as tests/test_torch_dp.py collates them) and the unknown label."""
    from gcdlss_tpu_torch.data import (SemanticKITTIDataset, build_label_mapping,
                                       collate_batch, dataset_meta, split_table,
                                       write_synthetic_kitti)

    write_synthetic_kitti(root, sequences=("00",), scans_per_seq=4, num_points=900, seed=2)
    meta = dataset_meta("SemanticKITTI")
    unknown, _ = split_table("SemanticKITTI", 1)
    mapping, _, unk = build_label_mapping(unknown, meta["learning_map_inv"].keys())
    kw = dict(voxel_size=0.15, label_mapping=mapping, unknown_labels=unknown, downsampling=800,
              augment=True, split_indices=np.array([0, 1]))
    lab = SemanticKITTIDataset(root, "train", labeled=True, resize_aug=True, seed=0, **kw)
    unlab = SemanticKITTIDataset(root, "train", labeled=False, seed=1, **kw)
    sides = [collate_batch([ds[0], ds[1]], S2_SIDE, point_cap=1024) for ds in (lab, unlab)]
    vox = [{k: np.asarray(v) for k, v in tcommon.voxel_batch_to_device(s["voxel"], "cpu").items()}
           for s in sides]
    pts = [{k: np.asarray(v) for k, v in tcommon.point_batch_to_device(s["points"], "cpu").items()}
           for s in sides]
    return vox, pts, unk


def _s1_cfg(**kw):
    return tpt.PretrainConfig(**{**dict(num_labeled_classes=17, num_classes=19, unknown_label=17,
                                        voxel_caps=CAPS, arch="MinkUNet14", planes=(8,) * 8,
                                        steps_per_epoch=1, epochs=2, warmup_epochs=1), **kw})


def _s2_kw(unk: int) -> dict:
    return dict(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                unknown_label=unk, voxel_caps=S2_CAPS, sup_voxel_cap=S2_SIDE,
                mix_voxel_caps=S2_CAPS, num_sup_scans=2, point_cap=1024, voxel_size=0.15,
                arch="MinkUNet14", planes=S2_PLANES, feat_dim=S2_PLANES[-1], cand_cap=2048,
                queue_slots=4, queue_per_slot=128, kmeans_iters=5, steps_per_epoch=1, epochs=3,
                warmup_epochs=1)


def _weights(sd: dict, seed: int) -> dict:
    """numpy values for every tensor of a port state dict, drawn in key
    order: sparse kernels He-normal, dense ones LeCun-normal, batch norms
    near the identity with running statistics away from their init."""
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(sd):
        shape = tuple(sd[key].shape)
        n = rng.standard_normal(shape)
        field = key.rsplit(".", 1)[1]
        if field == "kernel":
            v = n / np.sqrt(shape[0] * shape[2] / 2.0 if len(shape) == 3 else shape[0])
        elif field == "weight":
            v = 1.0 + 0.1 * n
        elif field == "running_var":
            v = 1.0 + 0.2 * np.abs(n)
        else:  # bias, running_mean
            v = 0.1 * n
        out[key] = v.astype(np.float32)
    return out


def _s1_trees() -> tuple:
    """The Stage-1 model's weights as the JAX package's (params, batch_stats)."""
    return state_dict_to_jax(_weights(tpt.make_model(_s1_cfg()).state_dict(), 1))


def _s2_tree(unk: int) -> dict:
    """A Stage-2 state as the JAX package's numpy trees (student = teacher,
    tau 0, an empty queue, step 0)."""
    cfg = td.DiscoverConfig(**_s2_kw(unk))
    params, stats = state_dict_to_jax(_weights(td.make_model(cfg).state_dict(), 2))
    q = (np.zeros((cfg.queue_slots, cfg.queue_per_slot, cfg.feat_dim), np.float32),
         np.zeros(cfg.queue_slots, np.int32), np.zeros((), np.int32))
    return dict(params_s=params, batch_stats_s=stats, params_t=params, batch_stats_t=stats,
                tau=np.float32(0.0), queue=q, step=0)


def _window_inputs(i: int, lvl: int, halo: int, world: int = 8):
    """Integer payloads of window case i: rows of the level, and every
    rank's window of partial sums."""
    rng = np.random.default_rng(100 + i)
    ln = CAPS[lvl] // world
    hp = vs.padded_halo(halo, ln)
    return (torch.as_tensor(rng.integers(-50, 50, (CAPS[lvl], 2))),
            torch.as_tensor(rng.integers(-50, 50, (world * (ln + 2 * hp), 2))))


def _normal(rng, shape, valid=None) -> torch.Tensor:
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    return x if valid is None else x * valid[:, None]


def _subm_inputs(valid):
    """x (valid rows), W and the output's cotangent of the stem conv case."""
    rng = np.random.default_rng(200)
    return (_normal(rng, (CAPS[0], 8), valid), _normal(rng, (125, 8, 16)),
            _normal(rng, (CAPS[0], 16)))


def _pool_inputs(p: int, plan):
    """Fine and coarse x (valid rows), W and the cotangents of a down conv
    (coarse rows) and an up conv (fine rows) on pool edge p."""
    rng = np.random.default_rng(300 + p)
    capf, capc = CAPS[p], CAPS[p + 1]
    return (_normal(rng, (capf, 6), plan.levels[p].valid),
            _normal(rng, (capc, 6), plan.levels[p + 1].valid), _normal(rng, (8, 6, 12)),
            _normal(rng, (capc, 12)), _normal(rng, (capf, 12)))


def _bn_input(valid):
    return _normal(np.random.default_rng(400), (CAPS[0], 5), valid)


def _t(d: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# ------------------------------------------------------------------ ranks


def _primitive_cases(group) -> dict:
    """World 8: windows and folds on integer payloads, their adjointness and
    autograd pair, the hop limit; the sharded stem conv at its required halo
    and one row under it; pool edges 0 and 3 down and up; batch-norm
    statistics. Each rank returns its own parts."""
    r, w = dist.get_rank(group), dist.get_world_size(group)
    b = _t(_batch())
    plan = build_unet_plan(b["coords"], b["valid"], CAPS, presorted=True)
    out = {}
    for i, (lvl, halo) in enumerate(WINDOWS):
        ln = CAPS[lvl] // w
        hp = vs.padded_halo(halo, ln)
        x, y = _window_inputs(i, lvl, halo, w)
        xl, yl = x[r * ln:(r + 1) * ln], y[r * (ln + 2 * hp):(r + 1) * (ln + 2 * hp)]
        win, fold = vs.halo_window(xl, halo, group), vs.fold_halo(yl, ln, hp, group)
        xf = xl.double().requires_grad_()
        (vs.halo_window(xf, halo, group) * yl.double()).sum().backward()
        yf = yl.double().requires_grad_()
        (vs.fold_halo(yf, ln, hp, group) * xl.double()).sum().backward()
        out[("window", lvl, halo)] = dict(
            win=win, fold=fold, dots=((win * yl).sum(), (xl * fold).sum()),
            grad_is_fold=torch.equal(xf.grad, fold.double()),
            grad_is_window=torch.equal(yf.grad, win.double()))
    lvl, halo = TOO_FAR
    try:
        vs.halo_window(torch.zeros(CAPS[lvl] // w, 2), halo, group)
        out["too_far"] = None
    except ValueError as exc:
        out["too_far"] = str(exc)

    # the stem conv (k = 5: the widest halo) with gradients
    nbr, valid = plan.stem_nbr, plan.levels[0].valid
    halo = int(vs.required_halo_subm(nbr, w))
    ln = CAPS[0] // w
    blk = slice(r * ln, (r + 1) * ln)
    x, wt, cot = _subm_inputs(valid)
    for h in (halo, halo - 1):
        book = vs.subm_book(nbr, h, group)
        xl, wl = x[blk].clone().requires_grad_(), wt.clone().requires_grad_()
        y, ovf = vs.sp_gather_conv(xl, book, wl)
        (y * cot[blk]).sum().backward()
        out[("subm", h)] = dict(y=y.detach(), dx=xl.grad, dw=wl.grad, ovf=ovf, nbr=book.nbr,
                                adj=book.adj)
    out["subm_halo"] = halo

    # pool edges: down and up, with gradients
    for p, halo in POOL_HALOS.items():
        lf, lc = CAPS[p] // w, CAPS[p + 1] // w
        pool = plan.pools[p]
        halo = halo or int(vs.required_halo_pool(pool.parent, CAPS[p + 1], w))
        book = vs.pool_book(pool, CAPS[p + 1], halo, group)
        xf, xc, wt, cot_c, cot_f = _pool_inputs(p, plan)
        res = {"halo": halo, "ovf": book.overflow}
        for kind, xin, lin, lout, cot, fn in (("down", xf, lf, lc, cot_c, vs.sp_down_conv),
                                              ("up", xc, lc, lf, cot_f, vs.sp_up_conv)):
            xl = xin[r * lin:(r + 1) * lin].clone().requires_grad_()
            wl = wt.clone().requires_grad_()
            y, _ = fn(xl, book, wl)
            (y * cot[r * lout:(r + 1) * lout]).sum().backward()
            res[kind] = dict(y=y.detach(), dx=xl.grad, dw=wl.grad)
        out[("pool", p)] = res

    # batch-norm statistics over the ring's rows
    xb = _bn_input(valid)
    out["bn"] = vs.sp_bn_stats(xb[blk], valid[blk], group)
    return out


def _step_cases(group, payload: dict) -> dict:
    """World 2: the sharded Stage-1 step (and with `remat`) from the JAX
    trees, and the sharded Stage-2 step with the JAX draws."""
    out = {}
    params, stats = _s1_trees()
    for remat in (False, True):
        cfg = _s1_cfg(remat=remat)
        state = tpt.create_pretrain_state(0, cfg, device="cpu")
        load_jax_params(state.model, params, stats)  # the weights bridge, into a sharded run
        step = sp_step.make_sp_pretrain_step(cfg, group, payload["s1_halos"], device="cpu")
        state, m = step(state, _t(payload["batch"]))
        out[("s1", remat)] = dict(metrics=m, model=_snapshot(state.model))
    cfg = td.DiscoverConfig(**_s2_kw(payload["unk"]))
    state = td.create_discover_state(0, cfg, device="cpu")
    load_jax_discover_state(state, payload["tree"])
    step = sp_discover.make_sp_discover_step(cfg, group, *payload["s2_halos"], device="cpu")
    sup, unsup = (_t(v) for v in payload["vox"])
    state, m = step(state, sup, unsup, draws=_t(payload["draws"]))
    out["s2"] = dict(metrics=m, student=_snapshot(state.student), teacher=_snapshot(state.teacher),
                     queue=tuple(a.clone() for a in state.queue))
    return out


def _dpsp_cases(group, payload: dict) -> dict:
    """World 4 (dp 2 x sp 2): rank r's batch group r // 2."""
    params, stats = _s1_trees()
    cfg = _s1_cfg(voxel_caps=tuple(c // 2 for c in CAPS))
    state = tpt.create_pretrain_state(0, cfg, device="cpu")
    load_jax_params(state.model, params, stats)
    step = sp_step.make_dp_sp_pretrain_step(cfg, payload["halos"], 2, device="cpu")
    state, m = step(state, _t(payload["groups"][dist.get_rank() // 2]))
    return dict(metrics=m, model=_snapshot(state.model))


CASES = {"primitives": _primitive_cases, "steps": _step_cases, "dpsp": _dpsp_cases}


def _worker(rank: int, world: int, tmp: str, job: str, payload) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        args = (dist.group.WORLD,) if job == "primitives" else (dist.group.WORLD, payload)
        torch.save(CASES[job](*args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(world: int, job: str, payload=None) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_worker, args=(world, tmp, job, payload), nprocs=world,
                           start_method="spawn", join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


@pytest.fixture(scope="module")
def world8():
    return _spawn(8, "primitives")


# ------------------------------------------------------------------ JAX


def _jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gcdlss_tpu.parallel import voxel_shard as jvs
    from gcdlss_tpu.parallel.mesh import make_mesh

    return jax, jnp, P, jvs, make_mesh


def _jax_plan():
    jax, jnp, _, _, _ = _jax()
    from gcdlss_tpu.ops.plan import build_unet_plan as jplan

    b = _batch()
    return jax.jit(lambda c, v: jplan(c, v, CAPS, presorted=True))(
        jnp.asarray(b["coords"]), jnp.asarray(b["valid"]))


def _shard(fn, in_specs, out_specs, n: int = 8, check_vma: bool = True):
    """`fn` under `shard_map` on n devices, jitted. The gradient cases pass
    check_vma=False (as `parallel/sp_discover.py` does): the replication
    checker rejects the custom VJP of `gather_conv` inside a per-shard
    `value_and_grad`."""
    jax, _, _, _, make_mesh = _jax()
    return jax.jit(jax.shard_map(fn, mesh=make_mesh(n, axis="sp"), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=check_vma))


def _cat(ranks: list, *keys):
    parts = []
    for res in ranks:
        v = res
        for k in keys:
            v = v[k]
        parts.append(v)
    return torch.cat(parts).numpy()


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got.detach() if hasattr(got, "detach") else got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max(initial=0)), 1e-3),
                               err_msg=what)


# ------------------------------------------------------------------ tests


def test_halo_sizing_matches_jax():
    """`required_halo_subm`, `required_halo_pool`, `required_halos` and
    `backbone_halos` of the fixture's plan at worlds 2, 4 and 8, bit for bit."""
    jax, _, _, jvs, _ = _jax()
    from gcdlss_tpu.parallel.sp_step import backbone_halos as jbackbone

    b = _t(_batch())
    plan = build_unet_plan(b["coords"], b["valid"], CAPS, presorted=True)
    jplan = _jax_plan()
    for n in (2, 4, 8):
        got = {k: int(v) for k, v in vs.required_halos(plan, n).items()}
        want = {k: int(v) for k, v in jax.jit(lambda p: jvs.required_halos(p, n))(jplan).items()}
        assert got == want, (n, got, want)
        assert int(vs.required_halo_subm(plan.levels[2].nbr3, n)) == want["subm2"]
        assert int(vs.required_halo_pool(plan.pools[1].parent, CAPS[2], n)) == want["pool1"]
        assert sp_step.backbone_halos(plan, n) == jbackbone(jplan, n), n


def test_window_and_fold_match_jax(world8):
    """At world 8: `halo_window` and `fold_halo` on integer payloads, slabs
    and 2- and 3-hop windows of 51-row blocks, bit for bit JAX's;
    <window(x), y> = <x, fold(y)> over the ring, and each is the other's
    autograd backward; 4 hops raise as JAX's do."""
    _, jnp, P, jvs, _ = _jax()
    for i, (lvl, halo) in enumerate(WINDOWS):
        ln = CAPS[lvl] // 8
        hp = vs.padded_halo(halo, ln)
        x, y = (a.numpy() for a in _window_inputs(i, lvl, halo))
        jwin = _shard(lambda a: jvs.halo_window(a, halo, "sp"), (P("sp"),), P("sp"))(
            jnp.asarray(x, jnp.int32))
        jfold = _shard(lambda a: jvs.fold_halo(a, ln, hp, "sp"), (P("sp"),), P("sp"))(
            jnp.asarray(y, jnp.int32))
        key = ("window", lvl, halo)
        np.testing.assert_array_equal(_cat(world8, key, "win"), np.asarray(jwin), err_msg=key)
        np.testing.assert_array_equal(_cat(world8, key, "fold"), np.asarray(jfold),
                                      err_msg=key)
        dots = np.array([[int(d) for d in res[key]["dots"]] for res in world8]).sum(0)
        assert dots[0] == dots[1], (key, dots)
        assert all(res[key]["grad_is_fold"] and res[key]["grad_is_window"] for res in world8)
    lvl, halo = TOO_FAR
    with pytest.raises(ValueError, match="ring hops") as jexc:
        _shard(lambda a: jvs.halo_window(a, halo, "sp"), (P("sp"),), P("sp"))(
            jnp.zeros((CAPS[lvl], 2)))
    assert all(res["too_far"] == str(jexc.value) for res in world8)


def test_sp_subm_conv_matches_jax_and_the_unsharded_conv(world8):
    """The sharded stem conv (k = 5) at its required halo: output, dX and dW
    against JAX's `sp_gather_conv` and the port's unsharded conv; the
    remapped books and the overflow bit for bit JAX's `_window_remap`, 0 at
    the required halo and > 0 one row under it; the adjoint book lists the
    forward book's entries."""
    jax, jnp, P, jvs, _ = _jax()
    jplan = _jax_plan()
    b = _t(_batch())
    plan = build_unet_plan(b["coords"], b["valid"], CAPS, presorted=True)
    halo = world8[0]["subm_halo"]
    assert halo > 1
    x, w, cot = _subm_inputs(plan.levels[0].valid)

    def sp_vag(x, w, nbr, cot):
        def local(x, w):
            out, ovf = jvs.sp_gather_conv(x, nbr, w, halo=halo, axis_name="sp")
            return jnp.sum(out * cot), (out, ovf)

        (_, (out, ovf)), (dx, dw) = jax.value_and_grad(local, argnums=(0, 1), has_aux=True)(x, w)
        return out, dx, jax.lax.psum(dw, "sp"), jax.lax.psum(ovf, "sp")

    jy, jdx, jdw, jovf = _shard(sp_vag, (P("sp"), P(), P("sp"), P("sp")),
                                (P("sp"),) * 2 + (P(),) * 2, check_vma=False)(
        jnp.asarray(x), jnp.asarray(w), jplan.stem_nbr, jnp.asarray(cot))
    got_y, got_dx = _cat(world8, ("subm", halo), "y"), _cat(world8, ("subm", halo), "dx")
    got_dw = sum(res[("subm", halo)]["dw"] for res in world8)
    _close(got_y, jy, CONV_TOL, "y vs JAX")
    _close(got_dx, jdx, CONV_TOL, "dx vs JAX")
    _close(got_dw, jdw, DW_TOL, "dw vs JAX")
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    yr = subm_conv(xr, plan.stem_nbr, wr)
    (yr * cot).sum().backward()
    _close(got_y, yr.detach(), CONV_TOL, "y vs unsharded")
    _close(got_dx, xr.grad, CONV_TOL, "dx vs unsharded")
    _close(got_dw, wr.grad, DW_TOL, "dw vs unsharded")

    for h in (halo, halo - 1):
        hp = vs.padded_halo(h, CAPS[0] // 8)
        jrel, jovf = _shard(lambda n: (lambda rel, o: (rel, jax.lax.psum(o, "sp")))(
            *jvs._window_remap(n, CAPS[0] // 8, hp, "sp")), (P("sp"),), (P("sp"), P()))(
                jplan.stem_nbr)
        np.testing.assert_array_equal(_cat(world8, ("subm", h), "nbr"), np.asarray(jrel))
        ovf = sum(int(res[("subm", h)]["ovf"]) for res in world8)
        assert ovf == int(jovf), (h, ovf, int(jovf))
        assert (ovf == 0) == (h == halo), (h, ovf)
        # the adjoint book lists the forward book's (window row, output row,
        # offset) triples: adj[v, k] = u wherever nbr[u, k] = v
        for res in world8:
            fwd, adj = res[("subm", h)]["nbr"].numpy(), res[("subm", h)]["adj"].numpy()
            u, k = np.nonzero(fwd >= 0)
            v, k2 = np.nonzero(adj >= 0)
            assert (sorted(zip(fwd[u, k].tolist(), u.tolist(), k.tolist()))
                    == sorted(zip(v.tolist(), adj[v, k2].tolist(), k2.tolist())))


def test_sp_pool_convs_and_bn_stats_match_jax_and_the_unsharded_ops(world8):
    """At world 8: `sp_down_conv` and `sp_up_conv` on pool edge 0 (a slab
    halo) and 3 (51-row coarse blocks, a 2-hop halo) with gradients, and
    `sp_bn_stats`, against JAX's (its one-pass statistics) and the port's
    unsharded ops; the pool overflow bit for bit JAX's, 0."""
    jax, jnp, P, jvs, _ = _jax()
    jplan = _jax_plan()
    b = _t(_batch())
    plan = build_unet_plan(b["coords"], b["valid"], CAPS, presorted=True)
    hops = []
    for p, fixed in POOL_HALOS.items():
        capf, capc = CAPS[p], CAPS[p + 1]
        lc = capc // 8
        pool, jpool = plan.pools[p], jplan.pools[p]
        res = [r[("pool", p)] for r in world8]
        halo = res[0]["halo"]
        required = int(jvs.required_halo_pool(jpool.parent, capc, 8))
        assert halo == (fixed or required) and halo >= required
        hops.append(-(-halo // lc))
        xf, xc, w, cot_c, cot_f = _pool_inputs(p, plan)

        def vag(kind):
            def fn(x, w, parent, dcode, cot):
                def local(x, w):
                    if kind == "down":
                        out, ovf = jvs.sp_down_conv(x, parent, dcode, w, lc, halo=halo,
                                                    axis_name="sp")
                    else:
                        out, ovf = jvs.sp_up_conv(x, parent, dcode, w, halo=halo, axis_name="sp")
                    return jnp.sum(out * cot), (out, ovf)

                (_, (out, ovf)), (dx, dw) = jax.value_and_grad(local, argnums=(0, 1),
                                                               has_aux=True)(x, w)
                return out, dx, jax.lax.psum(dw, "sp"), jax.lax.psum(ovf, "sp")
            return fn

        for kind, xin, cot, ref_fn in (
                ("down", xf, cot_c, lambda x, w: pool_conv(x, pool.children, pool.upmap, w)),
                ("up", xc, cot_f, lambda x, w: pool_conv(x, pool.upmap, pool.children, w))):
            jy, jdx, jdw, jovf = _shard(vag(kind), (P("sp"), P(), P("sp"), P("sp"), P("sp")),
                                        (P("sp"),) * 2 + (P(),) * 2, check_vma=False)(
                jnp.asarray(xin), jnp.asarray(w), jpool.parent, jpool.dcode, jnp.asarray(cot))
            got_y, got_dx = _cat(res, kind, "y"), _cat(res, kind, "dx")
            got_dw = sum(r[kind]["dw"] for r in res)
            _close(got_y, jy, CONV_TOL, f"{p} {kind} y vs JAX")
            _close(got_dx, jdx, CONV_TOL, f"{p} {kind} dx vs JAX")
            _close(got_dw, jdw, DW_TOL, f"{p} {kind} dw vs JAX")
            assert int(jovf) == sum(int(r["ovf"]) for r in res) == 0
            xr, wr = xin.clone().requires_grad_(), w.clone().requires_grad_()
            yr = ref_fn(xr, wr)
            (yr * cot).sum().backward()
            _close(got_y, yr.detach(), CONV_TOL, f"{p} {kind} y vs unsharded")
            _close(got_dx, xr.grad, CONV_TOL, f"{p} {kind} dx vs unsharded")
            _close(got_dw, wr.grad, DW_TOL, f"{p} {kind} dw vs unsharded")
            if kind == "down":
                _close(got_y, pconv.down_conv(xf, pool.parent, pool.dcode, w, capc), CONV_TOL,
                       f"{p} down vs the segment sum")
    assert hops == [1, 2], hops

    valid = plan.levels[0].valid
    xb = _bn_input(valid)
    jm, jv, jc = _shard(lambda x, v: jvs.sp_bn_stats(x, v, "sp"), (P("sp"), P("sp")),
                        (P(), P(), P()))(jnp.asarray(xb), jplan.levels[0].valid)
    rm, rv, rc = pconv.masked_batch_norm_stats(xb, valid)
    for res in world8:
        m, v, c = res["bn"]
        assert float(c) == float(jc) == float(rc)
        _close(m, jm, BN_TOL, "mean vs JAX")
        _close(v, jv, BN_TOL, "var vs JAX")
        _close(m, rm, BN_TOL, "mean vs unsharded")
        _close(v, rv, BN_TOL, "var vs unsharded")
        assert torch.equal(m, world8[0]["bn"][0]) and torch.equal(v, world8[0]["bn"][1])


# ------------------------------------------------------------------ steps


def _summary(a) -> np.ndarray:
    """max |a|, ||a|| and a's values at 32 positions fixed by its size (f32)."""
    a = np.asarray(a.detach() if hasattr(a, "detach") else a, np.float64).ravel()
    pos = np.sort(np.random.default_rng(a.size).choice(a.size, min(32, a.size), replace=False))
    return np.concatenate([[np.abs(a).max(initial=0), np.linalg.norm(a)], a[pos]]).astype(
        np.float32)


def _match(got, ref: np.ndarray, what: str) -> None:
    """`got` against a golden summary, within STATE_TOL of its largest
    magnitude (at least 1e-3)."""
    s = _summary(got)
    scale = max(float(ref[0]), 1e-3)
    assert s.shape == ref.shape, (what, s.shape, ref.shape)
    assert abs(s[1] - ref[1]) <= STATE_TOL * max(float(ref[1]), 1e-3), (what, s[1], ref[1])
    err = float(np.abs(s[2:] - ref[2:]).max(initial=0))
    assert err <= STATE_TOL * scale, (what, err, scale)


def _tree_layout(params: dict, stats: dict) -> np.ndarray:
    """'params|a/b/c|shape' and 'batch_stats|...' for every leaf, sorted."""
    def walk(tree, path):
        if isinstance(tree, dict):
            for k in tree:
                yield from walk(tree[k], path + (k,))
        else:
            yield "/".join(path), tuple(np.shape(tree))

    return np.array(sorted(f"{name}|{p}|{shape}" for name, tree in (("params", params),
                                                                   ("batch_stats", stats))
                           for p, shape in walk(tree, ())))


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDENS) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def steps(goldens, tmp_path_factory):
    """The one-process Stage-1 and Stage-2 steps from the JAX trees, and
    the same steps voxel-sharded over two ranks (Stage 1 also with `remat`),
    the Stage-2 ones with the JAX step's draws."""
    batch = _batch()
    params, stats = _s1_trees()
    cfg1 = _s1_cfg()
    state = tpt.create_pretrain_state(0, cfg1, device="cpu")
    load_jax_params(state.model, params, stats)
    plan1 = tcommon.plan_and_gather(_t(batch), CAPS)[0]
    state, m1 = tpt.pretrain_train_step(state, _t(batch), cfg1)
    one1 = dict(metrics=m1, model=_snapshot(state.model))

    vox, _, unk = _stage2_batches(str(tmp_path_factory.mktemp("kitti_sp")))
    cfg2 = td.DiscoverConfig(**_s2_kw(unk))
    tree = _s2_tree(unk)
    draws = {"num_areas": goldens["s2|draws|num_areas"],
             "kmeans_scores": goldens["s2|draws|kmeans_scores"]}
    state = td.create_discover_state(0, cfg2, device="cpu")
    load_jax_discover_state(state, tree)
    sup, unsup = (_t(v) for v in vox)
    plan2 = tcommon.plan_and_gather(td._combine_batches(sup, unsup, cfg2), S2_CAPS)[0]
    mix = sp_discover.probe_mix_plan(cfg2, state, sup, unsup, draws=_t(draws))
    s2_halos = (sp_step.backbone_halos(plan2, 2), sp_step.backbone_halos(mix, 2))
    state, m2 = td.discover_train_step(state, sup, unsup, cfg2, draws=_t(draws))
    one2 = dict(metrics=m2, student=_snapshot(state.student), teacher=_snapshot(state.teacher),
                queue=tuple(a.clone() for a in state.queue))
    payload = dict(batch=batch, s1_halos=sp_step.backbone_halos(plan1, 2), unk=unk, tree=tree,
                   vox=vox, draws=draws, s2_halos=s2_halos)
    return dict(one1=one1, one2=one2, ranks=_spawn(2, "steps", payload), unk=unk,
                s2_halos=s2_halos)


def _same_bits(ranks: list, key) -> None:
    a = ranks[0][key] if key is not None else ranks[0]
    for other in ranks[1:]:
        b = other[key] if key is not None else other
        for part in ("model", "student", "teacher"):
            for k, v in a.get(part, {}).items():
                assert torch.equal(v, b[part][k]), (key, part, k)
        for x, y in zip(a.get("queue", ()), b.get("queue", ())):
            assert torch.equal(x, y), key
        for k, v in a["metrics"].items():
            assert torch.equal(v, b["metrics"][k]), (key, k)


def _state_close(got: dict, ref: dict, what: str) -> None:
    assert set(got) == set(ref), what
    for k, v in ref.items():
        _close(got[k], v, STATE_TOL, f"{what} {k}")


def test_sp_stage1_step_is_the_one_process_step_and_jax(steps, goldens):
    """The Stage-1 step over two ranks, from the JAX trees (the weights
    bridge, `load_jax_params`, into a sharded run): loss, parameters and
    statistics of the one-process step and of JAX's `make_sp_pretrain_step`
    (goldens); `sp_overflow` and `plan_overflow` 0; the ranks the same bits;
    with `remat` (the recompute exchanges the halos again) the same bits as
    without."""
    ranks, one = steps["ranks"], steps["one1"]
    if not torch.cuda.is_available():  # the step factories default to the card
        for make in (lambda: sp_step.make_sp_pretrain_step(_s1_cfg(), None, (8,) * 10),
                     lambda: sp_step.make_dp_sp_pretrain_step(_s1_cfg(), (8,) * 10, 2),
                     lambda: sp_discover.make_sp_discover_step(
                         td.DiscoverConfig(**_s2_kw(steps["unk"])), None, (8,) * 10, (8,) * 10)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    params, stats = _s1_trees()
    np.testing.assert_array_equal(_tree_layout(params, stats), goldens["s1|layout"])
    for remat in (False, True):
        _same_bits(ranks, ("s1", remat))
    got = ranks[0][("s1", False)]
    for k, v in got["model"].items():
        assert torch.equal(v, ranks[0][("s1", True)]["model"][k]), k
    m = got["metrics"]
    assert int(m["sp_overflow"]) == 0 and int(m["plan_overflow"]) == 0
    assert int(goldens["s1|sp_overflow"][0]) == 0
    np.testing.assert_allclose(float(m["loss"]), float(one["metrics"]["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["loss"]), goldens["s1|loss"][0], rtol=LOSS_RTOL)
    _state_close(got["model"], one["model"], "one-process")
    names = {k.split("|", 2)[2] for k in goldens if k.startswith("s1|state|")}
    assert names == set(got["model"])
    for k, v in got["model"].items():
        _match(v, goldens[f"s1|state|{k}"], f"JAX {k}")


@pytest.fixture(scope="module")
def dpsp():
    """dp 2 x sp 2: the batch's two scans as two groups at half the caps,
    each over a ring of two; the one-process step on the whole batch."""
    batch = _batch()
    groups = _groups(batch)
    cfg_g = tuple(c // 2 for c in CAPS)
    halos = tuple(max(h) for h in zip(*[
        sp_step.backbone_halos(tcommon.plan_and_gather(_t(g), cfg_g)[0], 2) for g in groups]))
    params, stats = _s1_trees()
    state = tpt.create_pretrain_state(0, _s1_cfg(), device="cpu")
    load_jax_params(state.model, params, stats)
    state, m = tpt.pretrain_train_step(state, _t(batch), _s1_cfg())
    one = dict(metrics=m, model=_snapshot(state.model))
    return one, _spawn(4, "dpsp", dict(groups=groups, halos=halos))


def test_dp_sp_stage1_step_is_the_union_step(dpsp):
    """Four ranks, two batch groups of two-rank rings: convs exchange halos
    within a ring, batch norm, the loss and the gradients reduce over all
    four; the step is the one-process step on both groups' scans (loss,
    parameters, statistics); no overflow; every rank the same bits."""
    one, ranks = dpsp
    _same_bits(ranks, None)
    m = ranks[0]["metrics"]
    assert int(m["sp_overflow"]) == 0 and int(m["plan_overflow"]) == 0
    np.testing.assert_allclose(float(m["loss"]), float(one["metrics"]["loss"]), rtol=LOSS_RTOL)
    _state_close(ranks[0]["model"], one["model"], "union")


def test_sp_stage2_step_is_the_one_process_step_and_jax(steps, goldens):
    """The discovery step over two ranks (MinkUNet14, the LaserMix pass
    sharded with its probed halos), with the JAX step's draws: losses, tau,
    counts, the student and the EMA teacher with their statistics, and the
    queue, against the one-process step and JAX's `make_sp_discover_step`
    (goldens); `sp_overflow` 0; both ranks end with the same bits."""
    ranks, one = steps["ranks"], steps["one2"]
    cyl = td.DiscoverConfig(**{**_s2_kw(steps["unk"]), "arch": "Cylinder3D", "feat_dim": 128})
    with pytest.raises(NotImplementedError):
        sp_discover.make_sp_discover_step(cyl, None, (8,) * 10, (8,) * 10, device="cpu")
    _same_bits(ranks, "s2")
    got = ranks[0]["s2"]
    m, m1 = got["metrics"], one["metrics"]
    assert int(m["has_novel"]) == 1
    for k in COUNT_KEYS:
        if k in m1:
            assert int(m[k]) == int(m1[k]), k
        assert int(m[k]) == int(goldens[f"s2|metrics|{k}"][0]), k
    assert int(m["sp_overflow"]) == 0
    for k in LOSS_KEYS:
        for ref, what in ((float(m1[k]), "one-process"), (goldens[f"s2|metrics|{k}"][0], "JAX")):
            np.testing.assert_allclose(float(m[k]), ref, rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=f"{what} {k}")
    for who in ("student", "teacher"):
        _state_close(got[who], one[who], f"one-process {who}")
        for k, v in got[who].items():
            _match(v, goldens[f"s2|{who}|{k}"], f"JAX {who} {k}")
    _close(got["queue"][0], one["queue"][0], STATE_TOL, "queue feats")
    _match(got["queue"][0], goldens["s2|queue|feats"], "JAX queue feats")
    for i, name in ((1, "counts"), (2, "head")):
        assert torch.equal(got["queue"][i], one["queue"][i]), name
        np.testing.assert_array_equal(got["queue"][i].numpy(), goldens[f"s2|queue|{name}"])


# ------------------------------------------------------------------ goldens


def _jax_goldens(workdir: str) -> dict:
    """The JAX package's sharded steps from the same trees and inputs:
    Stage 1 by `make_sp_pretrain_step` on 2 devices; Stage 2 by
    `make_sp_discover_step` on 2 devices, halos from its own plans
    (`backbone_halos`, `probe_mix_plan`), and the draws its step takes."""
    jax, jnp, _, _, make_mesh = _jax()
    from gcdlss_tpu.ops.plan import build_unet_plan as jplan_of
    from gcdlss_tpu.parallel.sp_discover import make_sp_discover_step, probe_mix_plan
    from gcdlss_tpu.parallel.sp_step import backbone_halos, make_sp_pretrain_step
    from gcdlss_tpu.train import discover as jd
    from gcdlss_tpu.train import pretrain as jpt
    from gcdlss_tpu.train.discover import _combine_batches
    from gcdlss_tpu_torch.utils.weights import jax_to_state_dict

    g = {}
    # Stage 1. JAX's `make_sp_pretrain_step` takes its gradients inside
    # `shard_map`, whose replication checker (jax 0.9) rejects the custom
    # VJP of `gather_conv` there; its `shard_map` runs with check_vma=False,
    # as `make_sp_discover_step` runs its own
    import functools

    shard_map = jax.shard_map
    jax.shard_map = functools.partial(shard_map, check_vma=False)
    kw1 = {f.name: getattr(_s1_cfg(), f.name) for f in dataclasses.fields(_s1_cfg())}
    jcfg = jpt.PretrainConfig(**kw1)
    jstate = jpt.create_pretrain_state(jax.random.PRNGKey(0), jcfg)
    g["s1|layout"] = _tree_layout(jax.tree_util.tree_map(np.asarray, jstate.params),
                                  jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    params, stats = _s1_trees()
    assert np.array_equal(g["s1|layout"], _tree_layout(params, stats))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    plan = jax.jit(lambda c, v: jplan_of(c, v, CAPS, presorted=True))(jb["coords"], jb["valid"])
    step = make_sp_pretrain_step(jcfg, make_mesh(2, axis="sp"), backbone_halos(plan, 2))
    try:
        new, m = step(jstate, jb)
    finally:
        jax.shard_map = shard_map
    g["s1|loss"] = np.float32(m["loss"])[None]
    g["s1|sp_overflow"] = np.int32(m["sp_overflow"])[None]
    for k, v in jax_to_state_dict(jax.tree_util.tree_map(np.asarray, new.params),
                                  jax.tree_util.tree_map(np.asarray, new.batch_stats)).items():
        g[f"s1|state|{k}"] = _summary(v)

    # Stage 2
    vox, pts, unk = _stage2_batches(os.path.join(workdir, "kitti_sp"))
    jcfg = jd.DiscoverConfig(**_s2_kw(unk))
    tree = _s2_tree(unk)
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    jstate = jd.create_discover_state(jax.random.PRNGKey(5), jcfg).replace(
        params_s=j(tree["params_s"]), batch_stats_s=j(tree["batch_stats_s"]),
        params_t=j(tree["params_t"]), batch_stats_t=j(tree["batch_stats_t"]))
    _, k_kmeans, k_areas, _ = jax.random.split(jstate.rng, 4)
    n = min(jcfg.cand_cap, jcfg.voxel_caps[0]) + jcfg.queue_slots * jcfg.queue_per_slot
    g["s2|draws|num_areas"] = np.asarray(
        jax.random.choice(k_areas, jnp.asarray([3, 4, 5, 6], jnp.int32)))
    g["s2|draws|kmeans_scores"] = np.asarray(jax.random.uniform(k_kmeans, (n,)))
    sup_vb, unsup_vb = ({k: jnp.asarray(v) for k, v in d.items()} for d in vox)
    sup_pb, unsup_pb = ({k: jnp.asarray(v) for k, v in d.items()} for d in pts)
    coords, _, _, valid = _combine_batches(sup_vb, unsup_vb, jcfg)
    plan = jax.jit(lambda c, v: jplan_of(c, v, S2_CAPS, presorted=True))(coords, valid)
    mix = probe_mix_plan(jcfg, jstate, sup_vb, sup_pb, unsup_vb, unsup_pb)
    from jax.sharding import Mesh

    step = make_sp_discover_step(jcfg, Mesh(np.array(jax.devices()[:2]), ("sp",)),
                                 backbone_halos(plan, 2), backbone_halos(mix, 2))
    new, m = step(jstate, sup_vb, sup_pb, unsup_vb, unsup_pb)
    for k in LOSS_KEYS + COUNT_KEYS:
        g[f"s2|metrics|{k}"] = np.asarray(m[k], np.float64)[None]
    for who, side in (("student", "s"), ("teacher", "t")):
        sd = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, getattr(new, f"params_{side}")),
                               jax.tree_util.tree_map(np.asarray,
                                                      getattr(new, f"batch_stats_{side}")))
        for k, v in sd.items():
            g[f"s2|{who}|{k}"] = _summary(v)
    g["s2|queue|feats"] = _summary(np.asarray(new.queue.feats))
    g["s2|queue|counts"] = np.asarray(new.queue.counts)
    g["s2|queue|head"] = np.asarray(new.queue.head)
    return g


@pytest.mark.slow
def test_sp_goldens_are_the_jax_package(goldens, tmp_path):
    """The frozen goldens, rebuilt from the JAX package (minutes of XLA
    compile on the CPU)."""
    fresh = _jax_goldens(str(tmp_path))
    assert set(fresh) == set(goldens)
    for k, v in fresh.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(v, goldens[k], rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(v, goldens[k], err_msg=k)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sp.py <scratch dir>
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDENS, **_jax_goldens(sys.argv[1]))
    print(GOLDENS, file=sys.stderr)
