"""PyTorch port vs JAX package: the Stage-2 discovery slice on the CPU.

Building blocks (losses, cosine k-means, Hungarian, the queue, LaserMix's
voxel groups, `MinkUNetRC`) and two `discover_train_step`s at small size
(MinkUNet14, narrow planes, caps (2048, 1536, 1024, 512, 512)). The JAX
initial `DiscoverState` is carried into the port (`utils.weights`), and the
random draws the JAX step takes from `state.rng` (LaserMix's `num_areas`, the
k-means initial-row scores) are injected into the port's step. The port runs
its plain kernel versions here.

Tolerances: f32 on both sides, so floats differ by summation order only:
loss terms and tau rtol 1e-5 (atol 1e-6 for terms that are 0 up to
rounding), parameters, batch-norm statistics and queue features 1e-4 of each
tensor's largest magnitude (as in test_torch_slice.py). Counts, masks,
assignments and the confusion matrix are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcdlss_tpu.algo import hungarian_jax as jhung
from gcdlss_tpu.algo import kmeans as jkm
from gcdlss_tpu.algo import queue as jq
from gcdlss_tpu import losses as jl
from gcdlss_tpu.data import (SemanticKITTIDataset, build_label_mapping,
                             collate_batch, dataset_meta, split_table, write_synthetic_kitti)
from gcdlss_tpu.eval import metrics as jmet
from gcdlss_tpu.models import minkunet as jmk
from gcdlss_tpu.train import common as jcommon
from gcdlss_tpu.train import discover as jd
from gcdlss_tpu.train import lasermix as jlm
from gcdlss_tpu_torch import losses as tl
from gcdlss_tpu_torch.algo import hungarian as thung
from gcdlss_tpu_torch.algo import kmeans as tkm
from gcdlss_tpu_torch.algo import queue as tq
from gcdlss_tpu_torch.data import SemanticKITTIDataset as TorchSemanticKITTIDataset
from gcdlss_tpu_torch.eval import metrics as tmet
from gcdlss_tpu_torch.models import minkunet as tmk
from gcdlss_tpu_torch.train import common as tcommon
from gcdlss_tpu_torch.train import discover as td
from gcdlss_tpu_torch.train import lasermix as tlm
from gcdlss_tpu_torch.train.modules import ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive
from gcdlss_tpu_torch.train.pretrain import PretrainConfig, create_pretrain_state
from gcdlss_tpu_torch.utils.weights import (jax_to_state_dict, load_jax_discover_state,
                                            warm_start)

CAPS = (2048, 1536, 1024, 512, 512)
SUP_CAP = 1024
POINT_CAP = 700
PLANES = (16, 16, 32, 32, 32, 16, 16, 16)
LOSS_KEYS = ("loss", "sup_seg", "mse", "lasermix", "calib", "thr_loss", "novel_unsup",
             "novel_sup", "ncc_unsup")
COUNT_KEYS = ("n_cand", "n_rel", "has_novel", "plan_overflow", "cand_overflow")


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, ref, scale_tol=1e-4, what=""):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=scale_tol * max(float(np.abs(ref).max(initial=0)), 1e-6),
                               err_msg=what)


def _eq(got, ref, what=""):
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref), err_msg=what)


def _snapshot(model):
    """A copy of the state dict (its tensors alias the live parameters)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _jax_draws(rng_key, cfg):
    """The draws `_discover_step_impl` and `cosine_kmeans` take from state.rng."""
    _, k_kmeans, k_areas, _ = jax.random.split(rng_key, 4)
    n = min(cfg.cand_cap, cfg.voxel_caps[0]) + cfg.queue_slots * cfg.queue_per_slot
    num_areas = jax.random.choice(k_areas, jnp.asarray([3, 4, 5, 6], jnp.int32))
    return {"num_areas": _t(num_areas), "kmeans_scores": _t(jax.random.uniform(k_kmeans, (n,)))}


# ------------------------------------------------------------------ blocks


def test_stage2_losses_match_jax():
    rng = np.random.default_rng(0)
    n, c = 300, 18
    logits = rng.normal(size=(n, c)).astype(np.float32) * 3
    labels = rng.integers(-1, c, size=n).astype(np.int32)
    valid = rng.random(n) < 0.9
    pa = jax.nn.softmax(jnp.asarray(logits), -1)
    pb = jax.nn.softmax(jnp.asarray(rng.normal(size=(n, c)).astype(np.float32)), -1)
    tau = np.float32(0.3)
    cases = [
        (jl.calibration_loss(jnp.asarray(logits), jnp.asarray(labels), c - 1, jnp.asarray(valid)),
         tl.calibration_loss(_t(logits), _t(labels), c - 1, _t(valid))),
        (jl.mse_prob_loss(pa, pb, jnp.asarray(valid)), tl.mse_prob_loss(_t(pa), _t(pb), _t(valid))),
        (jl.mse_prob_loss(pa, pb), tl.mse_prob_loss(_t(pa), _t(pb))),
        (jl.adaptive_threshold_loss(jnp.asarray(logits[:, -1]), jnp.asarray(labels), c - 1,
                                    jnp.asarray(tau), jnp.asarray(valid)),
         tl.adaptive_threshold_loss(_t(logits[:, -1]), _t(labels), c - 1, torch.tensor(tau),
                                    _t(valid))),
        # an empty unknown set: its hinge term vanishes
        (jl.adaptive_threshold_loss(jnp.asarray(logits[:, -1]), jnp.asarray(labels), c + 5,
                                    jnp.asarray(tau)),
         tl.adaptive_threshold_loss(_t(logits[:, -1]), _t(labels), c + 5, torch.tensor(tau))),
    ]
    for j, t in cases:
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
    # the calibration gradient stays finite (NEG_INF is finite)
    x = _t(logits).requires_grad_()
    tl.calibration_loss(x, _t(labels), c - 1, _t(valid)).backward()
    assert torch.isfinite(x.grad).all()


def test_cosine_kmeans_matches_jax():
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(6, 16)).astype(np.float32)
    feats = (centers[rng.integers(0, 6, 700)] + 0.4 * rng.normal(size=(700, 16))).astype(
        np.float32)
    valid = rng.random(700) < 0.7
    key = jax.random.PRNGKey(3)
    ja, jc = jkm.cosine_kmeans(jnp.asarray(feats), jnp.asarray(valid), 7, key, iters=8)
    scores = jax.random.uniform(key, (700,))
    ta, tc = tkm.cosine_kmeans(_t(feats), _t(valid), 7, _t(scores), iters=8)
    _eq(ta, ja)
    _close(tc, jc, 1e-5)


def test_hungarian_small_matches_jax():
    rng = np.random.default_rng(2)
    for k in (2, 3, 4, 5):
        for maximize in (True, False):
            cost = rng.integers(0, 4, size=(k, k)).astype(np.float32)  # ties on purpose
            _eq(thung.hungarian_small(_t(cost), maximize),
                jhung.hungarian_small(jnp.asarray(cost), maximize))
    with pytest.raises(ValueError):
        thung.hungarian_small(torch.zeros(7, 7))


def test_queue_matches_jax():
    rng = np.random.default_rng(3)
    jqueue = jq.queue_init(3, 8, 4)
    tqueue = tq.queue_init(3, 8, 4)
    for n, p in ((20, 0.3), (5, 0.9), (12, 1.0), (6, 0.0)):  # wraps around
        f = rng.normal(size=(n, 4)).astype(np.float32)
        v = rng.random(n) < p
        jqueue = jq.queue_push(jqueue, jnp.asarray(f), jnp.asarray(v))
        tqueue = tq.queue_push(tqueue, _t(f), _t(v))
        for a, b in zip(tqueue, jqueue):
            _eq(a, b)
    for a, b in zip(tq.queue_flatten(tqueue), jq.queue_flatten(jqueue)):
        _eq(a, b)


def test_lasermix_voxel_groups_match_jax():
    """Every band edge of every num_areas is crossed many times; the rows
    whose f32 pitch lands on the other side of an edge than JAX's are
    counted, and there are none on this fixture."""
    rng = np.random.default_rng(4)
    n = 20000
    coords = np.zeros((n, 4), np.int32)
    coords[:, 0] = rng.integers(0, 4, n)
    coords[:, 1:3] = rng.integers(-800, 800, size=(n, 2))
    coords[:, 3] = rng.integers(-250, 40, n)
    is_sup = coords[:, 0] < 2
    for na in (3, 4, 5, 6):
        j = jlm.lasermix_voxel_groups(jnp.asarray(coords), jnp.asarray(is_sup), 2,
                                      jnp.asarray(na, jnp.int32), 0.05)
        t = tlm.lasermix_voxel_groups(_t(coords), _t(is_sup), 2,
                                      torch.tensor(na, dtype=torch.int32), 0.05)
        assert int((t.numpy() != np.asarray(j)).sum()) == 0, na
        assert set(np.unique(t.numpy())) == {0, 1, 2, 3}


def test_discovery_iou_matches_jax():
    rng = np.random.default_rng(5)
    conf = rng.integers(0, 50, size=(19, 19))
    known, unknown = list(range(17)), [17, 18]
    for a, b in zip(tmet.discovery_iou(conf, known, unknown, 19),
                    jmet.discovery_iou(conf, known, unknown, 19)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_variants_not_ported_raise():
    base = dict(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                unknown_label=17, voxel_caps=CAPS, sup_voxel_cap=SUP_CAP, mix_voxel_caps=CAPS,
                num_sup_scans=2, point_cap=POINT_CAP)
    for kw in (dict(threshold_mode="fixed_prob"), dict(assigner="sinkhorn"),
               dict(mix_mode="feature"), dict(mix_plan_mode="point"), dict(use_lion=True),
               dict(remat=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            td.make_model(td.DiscoverConfig(**base, **kw))
    for bad in (0, 3):
        with pytest.raises(ValueError):
            td.check_config(td.DiscoverConfig(**base, plan_kernel=bad))


def test_warm_start_from_stage1():
    """Backbone and `final` parameters come from the Stage-1 model; batch-norm
    statistics and the `final2`/`final3` heads stay as they were."""
    pcfg = PretrainConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                          voxel_caps=CAPS, arch="MinkUNet14", planes=PLANES)
    seg = create_pretrain_state(7, pcfg).model
    with torch.no_grad():
        seg.encoder.bn0.running_mean.fill_(5.0)
    sd = seg.state_dict()
    cfg = td.DiscoverConfig(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                            unknown_label=17, voxel_caps=CAPS, sup_voxel_cap=SUP_CAP,
                            mix_voxel_caps=CAPS, num_sup_scans=2, point_cap=POINT_CAP,
                            arch="MinkUNet14", planes=PLANES, feat_dim=PLANES[-1])
    fresh = td.make_model(cfg, torch.Generator().manual_seed(1))
    rc = td.make_model(cfg, torch.Generator().manual_seed(1))
    left = warm_start(rc, sd)
    assert left == ["encoder.final2.bias", "encoder.final2.kernel", "encoder.final3.bias",
                    "encoder.final3.kernel"]
    got, was = rc.state_dict(), fresh.state_dict()
    for k, v in got.items():
        if k in left or k not in dict(rc.named_parameters()):
            _eq(v, was[k], k)
        else:
            _eq(v, sd[k], k)
    state = td.create_discover_state(1, cfg, pretrained=sd)
    for k, v in state.teacher.state_dict().items():
        _eq(v, got[k], k)


# ------------------------------------------------------------- the step


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_s2"))
    write_synthetic_kitti(root, sequences=("00",), scans_per_seq=4, num_points=900, seed=2)
    meta = dataset_meta("SemanticKITTI")
    unknown, _ = split_table("SemanticKITTI", 1)
    mapping, inv, unk = build_label_mapping(unknown, meta["learning_map_inv"].keys())
    kw = dict(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
              unknown_label=unk, voxel_caps=CAPS, sup_voxel_cap=SUP_CAP, mix_voxel_caps=CAPS,
              num_sup_scans=2, point_cap=POINT_CAP, voxel_size=0.15, arch="MinkUNet14",
              planes=PLANES, feat_dim=PLANES[-1], cand_cap=256, queue_slots=4,
              queue_per_slot=64, kmeans_iters=5, steps_per_epoch=1, epochs=3,
              warmup_epochs=1)
    jcfg, tcfg = jd.DiscoverConfig(**kw), td.DiscoverConfig(**kw)
    dskw = dict(voxel_size=0.15, label_mapping=mapping, unknown_labels=unknown)

    def datasets(cls):
        return (cls(root, "train", split_indices=np.array([0, 1]), labeled=True,
                    downsampling=800, augment=True, resize_aug=True, seed=0, **dskw),
                cls(root, "train", split_indices=np.array([0, 1]), labeled=False,
                    downsampling=800, augment=True, seed=1, **dskw),
                cls(root, "valid", **dskw))

    # the batches both steps are fed come from the JAX package's datasets; the
    # port's experiment module runs on the port's own datasets and loaders
    lab_ds, unlab_ds, val_ds = datasets(SemanticKITTIDataset)
    port_ds = datasets(TorchSemanticKITTIDataset)
    sup = collate_batch([lab_ds[0], lab_ds[1]], SUP_CAP, point_cap=POINT_CAP)
    unsup = collate_batch([unlab_ds[0], unlab_ds[1]], CAPS[0] - SUP_CAP, point_cap=POINT_CAP)
    val = collate_batch([val_ds[0], val_ds[1]], CAPS[0], point_cap=1024)
    unknown_real = [k for k, v in mapping.items() if v == unk]
    lut = jcommon.inv_label_lut(inv, 19, {unk + i: r for i, r in enumerate(unknown_real)})

    # JAX: two steps from a fresh state (its step donates the state it gets)
    jstate = jd.create_discover_state(jax.random.PRNGKey(0), jcfg)
    tree0 = _np_tree(dict(params_s=jstate.params_s, batch_stats_s=jstate.batch_stats_s,
                          params_t=jstate.params_t, batch_stats_t=jstate.batch_stats_t,
                          tau=jstate.tau, queue=tuple(jstate.queue), step=jstate.step))
    jb = [jcommon.voxel_batch_to_device(sup["voxel"]), jcommon.point_batch_to_device(sup["points"]),
          jcommon.voxel_batch_to_device(unsup["voxel"]),
          jcommon.point_batch_to_device(unsup["points"])]
    jsteps = []
    for _ in range(2):
        draws = _jax_draws(jstate.rng, jcfg)
        jstate, jm = jd.discover_train_step(jstate, *jb, jcfg)
        jsteps.append(dict(draws=draws, metrics={k: np.asarray(v) for k, v in jm.items()},
                           state=_np_tree(dict(params_s=jstate.params_s,
                                               batch_stats_s=jstate.batch_stats_s,
                                               params_t=jstate.params_t,
                                               batch_stats_t=jstate.batch_stats_t,
                                               queue=tuple(jstate.queue), tau=jstate.tau))))
    jconf = np.asarray(jd.discover_eval_step(
        jstate, jcommon.voxel_batch_to_device(val["voxel"]),
        jcommon.point_batch_to_device(val["points"]), jnp.asarray(lut), jcfg))

    # the port: the same initial state, batches and draws
    tstate = td.create_discover_state(0, tcfg)
    load_jax_discover_state(tstate, tree0)
    tb = [tcommon.voxel_batch_to_device(sup["voxel"], "cpu"),
          tcommon.voxel_batch_to_device(unsup["voxel"], "cpu")]
    tsteps = []
    for js in jsteps:
        tstate, tm = td.discover_train_step(tstate, *tb, tcfg, draws=js["draws"])
        tsteps.append(dict(metrics=tm, student=_snapshot(tstate.student),
                           teacher=_snapshot(tstate.teacher),
                           queue=tuple(a.clone() for a in tstate.queue)))
    tconf = td.discover_eval_step(
        tstate, tcommon.voxel_batch_to_device(val["voxel"], "cpu"),
        tcommon.point_batch_to_device(val["points"], "cpu"), torch.as_tensor(lut), tcfg)
    return dict(jsteps=jsteps, tsteps=tsteps, jconf=jconf, tconf=tconf, tstate=tstate,
                tree0=tree0, tcfg=tcfg, jcfg=jcfg, sup=sup, unsup=unsup, mapping=mapping,
                inv=inv, lab_ds=port_ds[0], unlab_ds=port_ds[1], val_ds=port_ds[2])


def test_minkunet_rc_forward_matches_jax(setup):
    s = setup
    jmodel = jd.make_model(s["jcfg"])
    vb = s["sup"]["voxel"]

    @jax.jit
    def jfwd(params, stats, batch):
        plan, feats0, _, _ = jcommon.plan_and_gather(batch, CAPS)
        out = jmodel.apply({"params": params, "batch_stats": stats}, plan, feats0, train=False)
        return out, jmk.assemble_dummy_logits(out), jmk.assemble_novel_logits(out)

    jout, jdummy, jnovel = jfwd(s["tree0"]["params_s"], s["tree0"]["batch_stats_s"],
                                jcommon.voxel_batch_to_device(vb))
    state = td.create_discover_state(0, s["tcfg"])
    load_jax_discover_state(state, s["tree0"])
    state.student.eval()
    with torch.no_grad():
        plan, feats0, _, _ = tcommon.plan_and_gather(tcommon.voxel_batch_to_device(vb, "cpu"),
                                                     CAPS)
        tout = state.student(plan, feats0)
    for k in ("feats", "logits_known", "logits_ncc", "logits_novel"):
        _close(tout[k], jout[k], 1e-5, k)
    _close(tmk.assemble_dummy_logits(tout), jdummy, 1e-5)
    _close(tmk.assemble_novel_logits(tout), jnovel, 1e-5)
    assert tmk.assemble_novel_logits(tout).shape == (CAPS[0], 17 + 2 + 1)


@pytest.mark.parametrize("step", [0, 1])
def test_discover_step_metrics_match_jax(setup, step):
    jm, tm = setup["jsteps"][step]["metrics"], setup["tsteps"][step]["metrics"]
    for k in LOSS_KEYS + ("tau",):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
        assert np.isfinite(float(tm[k])), k
    for k in COUNT_KEYS:
        assert int(tm[k]) == int(jm[k]), k
    assert int(tm["n_cand"]) > 0


def test_discover_step_novel_branch_fires(setup):
    """The fixture exercises k-means, Hungarian and the queue push."""
    assert [int(s["metrics"]["has_novel"]) for s in setup["tsteps"]] == [1, 1]


@pytest.mark.parametrize("step", [0, 1])
def test_discover_step_queue_matches_jax(setup, step):
    jqueue, tqueue = setup["jsteps"][step]["state"]["queue"], setup["tsteps"][step]["queue"]
    _close(tqueue[0], jqueue[0], 1e-4, "queue feats")
    _eq(tqueue[1], jqueue[1], "queue counts")
    _eq(tqueue[2], jqueue[2], "queue head")


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("who", ["student", "teacher"])
def test_discover_step_params_and_stats_match_jax(setup, step, who):
    """The student after SGD (tau included) and the EMA teacher, with both
    models' batch-norm statistics."""
    js = setup["jsteps"][step]["state"]
    side = "s" if who == "student" else "t"
    ref = jax_to_state_dict(js[f"params_{side}"], js[f"batch_stats_{side}"])
    got = setup["tsteps"][step][who]
    assert set(ref) == set(got)
    for k, v in ref.items():
        _close(got[k], v, 1e-4, k)


def test_discover_ema_is_exact(setup):
    """t1 = 0.99 t0 + 0.01 s1 over the parameters, in the port's own state."""
    s0 = setup["tree0"]
    t0 = jax_to_state_dict(s0["params_t"], s0["batch_stats_t"])["encoder.conv0p1s1.kernel"]
    t1 = setup["tsteps"][0]["teacher"]["encoder.conv0p1s1.kernel"].numpy()
    s1 = setup["tsteps"][0]["student"]["encoder.conv0p1s1.kernel"].numpy()
    np.testing.assert_allclose(t1, 0.99 * t0 + 0.01 * s1, rtol=1e-6, atol=1e-7)


def test_discover_eval_confusion_matches_jax(setup):
    assert int(setup["tconf"].sum()) > 0
    _eq(setup["tconf"], setup["jconf"])


def test_exp_module_epoch_and_validate(setup):
    """The host loop through the port's datasets and loaders, with K4 maps."""
    s = setup
    cfg = dataclasses.replace(s["tcfg"], plan_kernel=1)
    exp = ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive(cfg, s["mapping"], s["inv"], seed=0)
    lab, unlab = exp.make_loaders(s["lab_ds"], s["unlab_ds"], num_workers=1)
    tm = exp.train_epoch(lab, unlab)
    assert len(exp.step_log) == 1 and np.isfinite(tm["loss"])
    assert {"tau", "n_cand", "has_novel", "plan_overflow", "seconds"} <= set(exp.step_log[0])
    vm = exp.validate(s["val_ds"], num_workers=1, point_cap=1024)
    assert vm["conf"].shape == (19, 19) and vm["conf"].sum() > 0
    assert 0.0 <= vm["mIoU"] <= 1.0 and np.isfinite(vm["mIoU_new"])
