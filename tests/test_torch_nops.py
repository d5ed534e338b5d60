"""PyTorch port vs JAX package: the single-model (NOPS-style) discovery
family on the CPU.

One step of each of the four recipes (ExpDiscover, ExpMixDiscoverJoint,
ExpMixDiscover through `nops_train_step`; ExpMixDiscoverSwaV through
`swav_train_step`) at `tests/test_nops.py`'s configuration (MinkUNet14,
8-wide planes, caps 2048 ...; the same `NopsConfig`s and batch shapes, so
the JAX package's cache can serve both files), from the JAX initial state
carried into the port (`utils.weights.load_jax_params`), with the draws the
JAX step takes from `state.rng` (the k-means scores; the mixing
permutations and Beta ratio) fed to the port's step. Then `_novel_branch`
alone (with one surviving cluster too), the SwaV second view's loader
seeding, the registry's `nops_config` against `main.py`, the state's
checkpoint round trip, and the JAX Stage-2 step at MinkUNet50 with
`main.py`'s queue width. The port runs its plain kernel versions here.

Tolerances: f32 on both sides, so floats differ by summation order only:
loss parts rtol 1e-5 (atol 1e-6 for a part that is 0 up to rounding);
parameters, batch-norm statistics and queue features 1e-4 of each tensor's
largest magnitude (as in test_torch_discover.py); counts, masks, labels and
the queue's counts and head exact.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcdlss_tpu.train import discover as jd
from gcdlss_tpu.train import nops as jn
from gcdlss_tpu.train.registry import MODULE_REGISTRY as JAX_REGISTRY
from gcdlss_tpu_torch.train import checkpoint as tck
from gcdlss_tpu_torch.train import nops as tn
from gcdlss_tpu_torch.train import registry as treg
from gcdlss_tpu_torch.utils.weights import jax_to_state_dict, load_jax_params

CAP = 2048
HALF = CAP // 2
# the base config of tests/test_nops.py (`_cfg`)
BASE = dict(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19, unknown_label=17,
            voxel_caps=(CAP, 1024, 512, 512, 256), sup_voxel_cap=HALF, num_sup_scans=2,
            arch="MinkUNet14", planes=(8, 8, 8, 8, 8, 8, 8, 8), feat_dim=8, cand_cap=256,
            queue_slots=4, kmeans_iters=3, prob_threshold=0.01, steps_per_epoch=2, epochs=2,
            warmup_epochs=1)
RECIPES = ("ExpDiscover", "ExpMixDiscoverJoint", "ExpMixDiscover", "ExpMixDiscoverSwaV")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one CPU thread while this module's tests run
    (several workers run at once; each worker's default pool would
    oversubscribe the cores). Restored when the module's tests end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, scale_tol, what=""):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=scale_tol * max(float(np.abs(ref).max(initial=0)), 1e-6),
                               err_msg=what)


def _eq(got, ref, what=""):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref), err_msg=what)


def _mk_voxel(rng, cap, nsc, voxel_size=0.1):
    """tests/test_nops.py's synthetic side: random coordinates in plan
    order, one point id a row."""
    pts = rng.uniform(-15, 15, size=(cap, 3))
    coords = np.concatenate([rng.integers(0, nsc, size=(cap, 1)).astype(np.int32),
                             np.floor(pts / voxel_size).astype(np.int32)], axis=1)
    order = np.lexsort((coords[:, 3], coords[:, 2], coords[:, 1], coords[:, 0]))
    coords = coords[order]
    return {"coords": coords, "feats": rng.uniform(0, 1, (cap, 1)).astype(np.float32),
            "labels": rng.integers(0, 17, cap).astype(np.int32),
            "mapped_labels": rng.integers(0, 17, cap).astype(np.int32),
            "valid": np.ones((cap,), bool),
            "point_ids": np.arange(cap, dtype=np.int32)[order]}


def _cfgs(name):
    stage, overrides = JAX_REGISTRY[name]
    jcfg = jn.NopsConfig(**{**BASE, **overrides})
    return stage, jcfg, tn.NopsConfig(**dataclasses.asdict(jcfg))


def _jax_draws(rng_key, cfg, swav):
    """The draws `nops_train_step` / `swav_train_step` take from state.rng
    (`nops.py:234,423`), through `euclidean_kmeans` and the mixing
    functions (`feature_mixing.py`)."""
    n = min(cfg.cand_cap, cfg.voxel_caps[0]) + cfg.queue_slots
    if swav:
        _, k1, k2 = jax.random.split(rng_key, 3)
        return {"kmeans_scores": _t(jax.random.uniform(k1, (n,))),
                "kmeans_scores_b": _t(jax.random.uniform(k2, (n,)))}
    _, k_kmeans, k_mix, k_umix = jax.random.split(rng_key, 4)
    cap0 = cfg.voxel_caps[0]
    draws = {"kmeans_scores": _t(jax.random.uniform(k_kmeans, (n,)))}
    if cfg.use_mix_features:
        keys = jax.random.split(k_mix, 3)
        count = 3 if cfg.mix_centroid else 2
        draws["mix_perms"] = tuple(_t(jax.random.permutation(k, cap0)) for k in keys[:count])
        if not cfg.mix_centroid:
            draws["mix_ratio"] = float(jax.random.beta(keys[2], cfg.beta_coeff, cfg.beta_coeff))
    if cfg.unsup_mix_coeff > 0:
        draws["umix_perms"] = tuple(_t(jax.random.permutation(k, cap0))
                                    for k in jax.random.split(k_umix, 3))
    return draws


@pytest.fixture(scope="module", params=RECIPES)
def run(request):
    """One step of the recipe in both packages from the JAX initial state at
    PRNGKey(0), on the same batches with the same draws."""
    stage, jcfg, tcfg = _cfgs(request.param)
    swav = stage == "nops_swav"
    rng = np.random.default_rng(0)
    sides = [_mk_voxel(rng, HALF, 2), _mk_voxel(rng, CAP - HALF, 2)]
    if swav:  # the same points a second time: shifted, with fresh features
        for side in list(sides):
            sides.append(dict(side, coords=side["coords"] + np.array([0, 1, 0, 0], np.int32),
                              feats=rng.uniform(0, 1, side["feats"].shape).astype(np.float32)))
    jstate = jn.create_nops_state(jax.random.PRNGKey(0), jcfg)
    params0 = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.batch_stats))
    draws = _jax_draws(jstate.rng, jcfg, swav)
    jstep = jn.swav_train_step if swav else jn.nops_train_step
    jstate, jm = jstep(jstate, *[{k: jnp.asarray(v) for k, v in s.items()} for s in sides], jcfg)
    tstate = tn.create_nops_state(0, tcfg, device="cpu")
    load_jax_params(tstate.model, *params0)
    sd0 = {k: v.detach().clone() for k, v in tstate.model.state_dict().items()}
    tstep = tn.swav_train_step if swav else tn.nops_train_step
    tstate, tm = tstep(tstate, *[{k: _t(v) for k, v in s.items()} for s in sides], tcfg,
                       draws=draws)
    return dict(name=request.param, swav=swav, jm={k: np.asarray(v) for k, v in jm.items()},
                tm={k: float(v) for k, v in tm.items()}, tstate=tstate, sd0=sd0,
                jsd=jax_to_state_dict(*jax.tree_util.tree_map(
                    np.asarray, (jstate.params, jstate.batch_stats))),
                jqueue=tuple(np.asarray(a) for a in jstate.queue), jstep=int(jstate.step))


def test_nops_step_losses_and_counts_match_jax(run):
    """Every metric of the JAX step (loss parts, n_cand, n_rel, has_novel);
    the novel branch fires and SwaV's two views match candidates."""
    jm, tm = run["jm"], run["tm"]
    assert set(jm) <= set(tm)
    for k, ref in jm.items():
        assert np.isfinite(tm[k]), k
        if k in ("n_cand", "n_rel", "has_novel"):
            assert int(tm[k]) == int(ref), (k, tm[k], ref)
        else:
            np.testing.assert_allclose(tm[k], float(ref), rtol=1e-5, atol=1e-6, err_msg=k)
    # (the random coordinates do not pool: the plans drop voxels from L1 on,
    # the same ones on both sides; plan parity at overflow: test_torch_plan.py)
    assert int(jm["has_novel"]) == 1
    if run["swav"]:
        assert tm["n_match"] > 0 and tm["swav"] > 0
    else:
        assert tm["novel_unsup"] > 0 and tm["n_rel"] > 0
    if run["name"] == "ExpMixDiscover":
        assert tm["unsup_mix"] > 0 and tm["entropy"] != 0


def test_nops_step_params_and_stats_match_jax(run):
    """Every parameter and batch-norm statistic after the SGD step; the
    novel head's update on its own scale (a missing stop-gradient in the
    novel CE or a detached head would move it or the backbone off)."""
    got = run["tstate"].model.state_dict()
    assert set(got) == set(run["jsd"])
    for k, ref in run["jsd"].items():
        _close(got[k], ref, 1e-4, k)
    for k in ("encoder.final3.kernel", "encoder.final3.bias"):
        delta = run["jsd"][k] - run["sd0"][k].numpy()
        assert np.abs(delta).max() > 0, k
        _close(got[k] - run["sd0"][k], delta, 1e-3, f"update of {k}")
    assert run["tstate"].step == run["jstep"] == 1


def test_nops_step_queue_matches_jax(run):
    """The mean reliable feature pushed into one slot (has_novel fired)."""
    tq = run["tstate"].queue
    _close(tq.feats, run["jqueue"][0], 1e-4, "queue feats")
    _eq(tq.counts, run["jqueue"][1], "queue counts")
    _eq(tq.head, run["jqueue"][2], "queue head")
    assert int(tq.counts.sum()) == 1


@pytest.mark.parametrize("case", ["mixed", "one_cluster"])
def test_novel_branch_matches_jax(case):
    """`_novel_branch` on its own, every output, against the JAX function
    (eager): candidates past the NCC threshold in plan order, capped; a
    half-full queue; and a set where one cluster alone survives the drop
    (the relabel then clips every label to 0)."""
    rng = np.random.default_rng(5)
    K, Ku, C, n = 17, 2, 8, 600
    cfg = jn.NopsConfig(**{**BASE, "cand_cap": 128, "queue_slots": 4, "kmeans_iters": 4,
                           "prob_threshold": 0.2})
    dummy = rng.normal(size=(n, K + 1)).astype(np.float32) * 2
    feats = rng.normal(size=(n, C)).astype(np.float32)
    unsup = rng.random(n) < 0.6
    params = {"final": {"kernel": rng.normal(size=(C, K)).astype(np.float32)},
              "final3": {"kernel": rng.normal(size=(C, Ku)).astype(np.float32),
                         "bias": rng.normal(size=Ku).astype(np.float32)}}
    qfeats = np.zeros((4, 1, C), np.float32)
    qfeats[:2, 0] = rng.normal(size=(2, C))
    counts = np.array([1, 1, 0, 0], np.int32)
    if case == "one_cluster":
        # two tight groups, one on the base prototypes: it is dropped
        proto = params["final"]["kernel"].T.mean(0)
        group = rng.random(n) < 0.5
        feats = np.where(group[:, None], proto, proto + 25.0).astype(np.float32)
        qfeats[:] = 0
        counts[:] = 0
    key = jax.random.PRNGKey(3)
    scores = jax.random.uniform(key, (128 + 4,))
    jqueue = jn.FeatureQueue(feats=jnp.asarray(qfeats), counts=jnp.asarray(counts),
                             head=jnp.asarray(2, jnp.int32))
    ref = jn._novel_branch(cfg, jnp.asarray(dummy), jnp.asarray(feats), jnp.asarray(unsup),
                           jqueue, params, key)
    heads = SimpleNamespace(
        final=SimpleNamespace(kernel=_t(params["final"]["kernel"])),
        final3=SimpleNamespace(kernel=_t(params["final3"]["kernel"]),
                               bias=_t(params["final3"]["bias"])))
    tqueue = tn.FeatureQueue(_t(qfeats), _t(counts), torch.tensor(2, dtype=torch.int32))
    got = tn._novel_branch(tn.NopsConfig(**dataclasses.asdict(cfg)), _t(dummy), _t(feats),
                           _t(unsup), tqueue, heads, _t(scores), torch.arange(n))
    # the port's `own` (the candidates whose terms a rank takes) is every one
    assert set(got) == set(ref) | {"own"}
    _eq(got.pop("own"), ref["cand_valid"], "own")
    for k, v in ref.items():
        if k == "cand_feats":
            _close(got[k], v, 1e-6, k)
        else:
            _eq(got[k], v, k)
    assert int(ref["n_rel"]) > 0 and bool(ref["has_novel"])
    if case == "one_cluster":
        rel = np.asarray(ref["rel_mask"])
        assert len(np.unique(np.asarray(ref["mapped_novel"])[rel])) == 1


def test_swav_second_view_seeding(tmp_path):
    """The second view's loaders (`view=1`) give the same scans in the same
    order, other augmentation draws (coordinates differ), and point ids of
    one identity space: a point id both views keep carries one label. Two
    loaders built as the JAX CLI builds them (the same seeds, the default
    view) would give the same view twice."""
    from gcdlss_tpu_torch.data import SemanticKITTIDataset, make_loader, write_synthetic_kitti

    write_synthetic_kitti(str(tmp_path), sequences=("00",), scans_per_seq=4, num_points=900,
                          seed=3)
    ds = SemanticKITTIDataset(str(tmp_path), "train", voxel_size=0.15, downsampling=-1,
                              augment=True, seed=5)

    def batches(view):
        return list(make_loader(ds, 2, 2048, seed=7, epoch=3, num_workers=1, view=view))

    a, b, again = batches(0), batches(1), batches(0)
    assert len(a) == len(b) == 2
    for x, y, z in zip(a, b, again):
        va, vb = x["voxel"], y["voxel"]
        _eq(vb.scan_ids, va.scan_ids)
        _eq(z["voxel"].coords, va.coords)  # the collapse: the same seeds, the same view
        assert not np.array_equal(va.coords, vb.coords)
        for s in range(2):
            ra = va.valid & (va.coords[:, 0] == s)
            rb = vb.valid & (vb.coords[:, 0] == s)
            la = dict(zip(va.point_ids[ra].tolist(), va.labels[ra].tolist()))
            lb = dict(zip(vb.point_ids[rb].tolist(), vb.labels[rb].tolist()))
            shared = set(la) & set(lb)
            assert len(shared) > 0.3 * min(len(la), len(lb))
            assert all(la[p] == lb[p] for p in shared)


def test_nops_config_follows_main():
    """`nops_config` builds what `main.py:447-468` builds for each recipe:
    the sup rows at half of cap0, batch_size // 2 scans a side, the recipe's
    overrides; the two packages' NopsConfig have the same fields and
    defaults but the planes' container."""
    jf = {f.name: f.default for f in dataclasses.fields(jn.NopsConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tn.NopsConfig)}
    assert jf.keys() == tf.keys()
    assert {k for k in jf if jf[k] != tf[k]} == set()
    caps = (4096, 2048, 1024, 512, 256)
    label = dict(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                 unknown_label=17)
    for name in RECIPES:
        stage, cfg = treg.nops_config(name, voxel_caps=caps, batch_size=6, **label, lr=0.3)
        jstage, overrides = JAX_REGISTRY[name]
        ref = jn.NopsConfig(**label, voxel_caps=caps, sup_voxel_cap=2048, num_sup_scans=3,
                            lr=0.3, **overrides)
        assert stage == jstage and dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
    with pytest.raises(ValueError):
        treg.nops_config("ExpFineTuning", voxel_caps=caps, batch_size=2, **label)


def test_nops_checkpoint_round_trip(tmp_path):
    """A used state (SGD momentum, a pushed queue, a drawn generator, the
    step) saved and restored into a fresh one: every tensor bit-equal, and
    the next step's draws and metrics equal."""
    _, _, cfg = _cfgs("ExpMixDiscover")
    rng = np.random.default_rng(4)
    sides = [{k: _t(v) for k, v in _mk_voxel(rng, n, 2).items()} for n in (HALF, CAP - HALF)]
    state = tn.create_nops_state(0, cfg, device="cpu")
    state, _ = tn.nops_train_step(state, *sides, cfg)
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(state.step, state)
    other = mgr.restore(tn.create_nops_state(1, cfg, device="cpu"))
    assert torch.equal(state.generator.get_state(), other.generator.get_state())
    sd, so = state.model.state_dict(), other.model.state_dict()
    assert all(torch.equal(sd[k], so[k]) for k in sd)
    assert all(torch.equal(x, y) for x, y in zip(state.queue, other.queue))
    assert int(state.queue.counts.sum()) == 1 and other.step == state.step == 1
    _, m1 = tn.nops_train_step(state, *sides, cfg)
    _, m2 = tn.nops_train_step(other, *sides, cfg)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(sd[k], so[k]) for k in sd)


def test_jax_stage2_at_minkunet50_cannot_fill_its_queue():
    """`main.py:551-554` keeps the Stage-2 queue width at its default while a
    bottleneck MinkUNet's features are 4 planes wide (MinkUNet50: 96 and
    384), so the JAX step cannot push its candidates into the queue: its
    trace fails on the shapes (no compile). With the backbone's width, as
    the port's CLI sets it, it traces. Narrow planes: 8 against 32."""
    planes = (8,) * 8
    kw = dict(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
              unknown_label=17, voxel_caps=(512, 256, 256, 256, 256), sup_voxel_cap=256,
              mix_voxel_caps=(512, 256, 256, 256, 256), num_sup_scans=1, point_cap=64,
              arch="MinkUNet50", planes=planes, cand_cap=64, queue_slots=2,
              queue_per_slot=16, kmeans_iters=1)

    def side(n):
        coords = np.zeros((n, 4), np.int32)
        coords[:, 1] = np.arange(n)
        return {"coords": jnp.asarray(coords), "feats": jnp.zeros((n, 1)),
                "labels": jnp.zeros(n, jnp.int32), "mapped_labels": jnp.zeros(n, jnp.int32),
                "valid": jnp.ones(n, bool)}

    def points():
        return {"xyz": jnp.zeros((1, 64, 3)), "feats": jnp.zeros((1, 64, 1)),
                "labels": jnp.zeros((1, 64), jnp.int32),
                "mapped_labels": jnp.zeros((1, 64), jnp.int32),
                "valid": jnp.zeros((1, 64), bool), "voxel_row": jnp.zeros((1, 64), jnp.int32)}

    def trace(feat_dim):
        cfg = jd.DiscoverConfig(**kw, feat_dim=feat_dim)
        state = jax.eval_shape(lambda: jd.create_discover_state(jax.random.PRNGKey(0), cfg))
        return jax.eval_shape(lambda s: jd.discover_train_step(
            s, side(256), points(), side(256), points(), cfg), state)

    with pytest.raises(TypeError, match="concatenate"):  # the candidates beside the queue
        trace(planes[7])  # main.py's rule: the default width, not the backbone's
    out = trace(planes[7] * 4)  # the port's rule: DEFAULT_PLANES[7] x the block's expansion
    assert out[1]["loss"].shape == ()
