"""PyTorch port vs JAX package: the Stage-2 discovery family on the CPU.

Building blocks (the four Sinkhorn functions, the six LiON functions,
`lookup_sorted`, `sparse_quantize`, `batched_coordinates`, LaserMix on the
points, the point-mode mixed plan, `SemanticEval`, `IoUEval`,
`euclidean_kmeans`, `algo/clustering`, `clustering_eval`) and two
`discover_train_step`s of each of eight configs: the seven Stage-2 recipes
the registry adds to the default one (threshold modes, Sinkhorn, PolarMix-MT
feature mixing, LiON) and the default recipe with the point-mode mixed plan,
at `test_torch_discover.py`'s size (MinkUNet14, narrow planes, caps 2048 ...).
One JAX state is carried into the port (`load_jax_discover_state`); the
JAX step's draws (`num_areas`, the k-means scores, the feature-mix
permutations of `k_featmix`) are injected into the port's step. The port
runs its plain kernel versions here.

Tolerances as in `test_torch_discover.py`: loss terms and tau rtol 1e-5
(atol 1e-6), tensors 1e-4 of each tensor's largest magnitude, counts, masks
and confusion matrices exact; integer outputs of the quantizer and plans bit
for bit.

The JAX package's Sinkhorn functions return NaN in every valid row as soon
as one row is masked (ROADMAP Queue 3); the port leaves masked rows out of
the marginals. Its Sinkhorn functions are held to the JAX ones on the valid
rows alone, and the Sinkhorn step to the JAX step with `sinkhorn_knopp`
swapped, in this file only, for `_jax_sinkhorn_valid_rows`, a JAX twin that
is itself held to the JAX package's function on the valid rows.
"""


import jax
import jax.numpy as jnp
import jax.scipy.special as jss
import numpy as np
import pytest
import torch

from gcdlss_tpu import losses_lion as jlion
from gcdlss_tpu.algo import clustering as jclu
from gcdlss_tpu.algo import kmeans as jkm
from gcdlss_tpu.algo import sinkhorn as jsk
from gcdlss_tpu.data import (SemanticKITTIDataset, build_label_mapping, collate_batch,
                             dataset_meta, split_table, write_synthetic_kitti)
from gcdlss_tpu.data.quantize_np import sparse_quantize_np
from gcdlss_tpu.eval import clustering_eval as jce
from gcdlss_tpu.eval import ioueval as jioue
from gcdlss_tpu.eval import metrics as jmet
from gcdlss_tpu.ops import coords as jco
from gcdlss_tpu.ops import voxelize as jvox
from gcdlss_tpu.train import common as jcommon
from gcdlss_tpu.train import discover as jd
from gcdlss_tpu.train import lasermix as jlm
from gcdlss_tpu_torch import losses_lion as tlion
from gcdlss_tpu_torch.algo import clustering as tclu
from gcdlss_tpu_torch.algo import kmeans as tkm
from gcdlss_tpu_torch.algo import sinkhorn as tsk
from gcdlss_tpu_torch.eval import clustering_eval as tce
from gcdlss_tpu_torch.eval import ioueval as tioue
from gcdlss_tpu_torch.eval import metrics as tmet
from gcdlss_tpu_torch.main import resolve_discover_overrides
from gcdlss_tpu_torch.ops import coords as tco
from gcdlss_tpu_torch.ops import plan as tplan
from gcdlss_tpu_torch.ops import voxelize as tvox
from gcdlss_tpu_torch.train import common as tcommon
from gcdlss_tpu_torch.train import discover as td
from gcdlss_tpu_torch.train import lasermix as tlm
from gcdlss_tpu_torch.utils.weights import jax_to_state_dict, load_jax_discover_state

CAPS = (2048, 1536, 1024, 512, 512)
SUP_CAP = 1024
POINT_CAP = 700
PLANES = (16, 16, 32, 32, 32, 16, 16, 16)
LOSS_KEYS = ("loss", "sup_seg", "mse", "lasermix", "calib", "thr_loss", "novel_unsup",
             "novel_sup", "ncc_unsup")
COUNT_KEYS = ("n_cand", "n_rel", "has_novel", "plan_overflow", "cand_overflow")
DEFAULT = "ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive"
# config id -> (registry recipe, extra overrides)
VARIANTS = {
    "fixed_prob": ("ExpMergeDiscover_LaserMix_MeanTeacher", {}),
    "hybrid": ("ExpMergeDiscover_LaserMix_MeanTeacher_HybridAdaptive", {}),
    "oracle": ("ExpMergeDiscover_LaserMix_MeanTeacher_Oracle_threshold", {}),
    "msp": ("ExpMergeDiscover_LaserMix_MeanTeacher_MSP_threshold", {}),
    "polarmix": ("ExpMergeDiscover_PolarMix_MeanTeacher", {}),
    "sinkhorn": ("ExpMixRealMeanTeacherDiscover", {}),
    "lion": ("ExpMergeDiscover_LaserMix_LiON_MeanTeacher", {}),
    "point": (DEFAULT, {"mix_plan_mode": "point"}),
}
# the configs whose novel branch must fire in both steps
MUST_FIRE = ("fixed_prob", "sinkhorn")
NCC_BIAS = 1.5


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
    return torch.as_tensor(np.asarray(a))


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _close(got, ref, scale_tol=1e-4, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=scale_tol * max(float(np.abs(ref).max(initial=0)), 1e-6),
                               err_msg=what)


def _eq(got, ref, what=""):
    np.testing.assert_array_equal(_np(got), np.asarray(ref), err_msg=what)


def _jax_sinkhorn_valid_rows(features, head, valid=None, queue=None, queue_valid=None,
                             num_iters: int = 3, epsilon: float = 0.05):
    """`gcdlss_tpu.algo.sinkhorn.sinkhorn_knopp` with the masked rows left
    out of the column sums (the port's rule), for the JAX Sinkhorn step."""
    n = features.shape[0]
    if queue is not None:
        features = jnp.concatenate([features, queue], axis=0)
        valid = jnp.concatenate([valid, queue_valid])
    vm = valid[:, None]
    z = features / jnp.maximum(jnp.linalg.norm(features, axis=-1, keepdims=True), 1e-8)
    c = head / jnp.maximum(jnp.linalg.norm(head, axis=0, keepdims=True), 1e-8)
    logq = (z @ c) / epsilon
    b = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)
    for _ in range(num_iters):
        col = jss.logsumexp(jnp.where(vm, logq, -jnp.inf), axis=0, keepdims=True)
        logq = logq - jnp.where(jnp.isfinite(col), col, 0.0) - jnp.log(head.shape[1])
        logq = logq - jss.logsumexp(logq, axis=1, keepdims=True) - jnp.log(b)
    return jnp.where(vm, jnp.exp(logq) * b, 0.0)[:n]


# ------------------------------------------------------------------ blocks


def test_sinkhorn_family_matches_jax():
    """Unmasked: the port equals the JAX functions. Masked: the JAX
    functions return NaN in the valid rows (the fault, shown here); the
    port's valid rows equal the JAX functions run on the valid rows alone,
    its masked rows are zeros; with no valid row at all (no candidate, an
    empty queue) everything is zero and no NaN reaches an argmax. The
    semi-relaxed solver masks by multiplication and is compared as is."""
    rng = np.random.default_rng(0)
    f = rng.normal(size=(40, 12)).astype(np.float32)
    head = rng.normal(size=(12, 5)).astype(np.float32)
    queue = rng.normal(size=(16, 12)).astype(np.float32)
    logw = rng.normal(size=5).astype(np.float32)
    v = rng.random(40) < 0.7
    qv = rng.random(16) < 0.5
    j, t = jnp.asarray, _t
    tol = 2e-5

    _close(tsk.sinkhorn_knopp(t(f), t(head)), jsk.sinkhorn_knopp(j(f), j(head)), tol)
    _close(tsk.sinkhorn_knopp(t(f), t(head), valid=t(np.ones(40, bool)), queue=t(queue),
                              queue_valid=t(np.ones(16, bool))),
           jsk.sinkhorn_knopp(j(f), j(head), valid=j(np.ones(40, bool)), queue=j(queue),
                              queue_valid=j(np.ones(16, bool))), tol)
    masked_jax = np.asarray(jsk.sinkhorn_knopp(j(f), j(head), valid=j(v), queue=j(queue),
                                               queue_valid=j(qv)))
    assert np.isnan(masked_jax[v]).all() and (masked_jax[~v] == 0).all()
    got = tsk.sinkhorn_knopp(t(f), t(head), valid=t(v), queue=t(queue), queue_valid=t(qv))
    ref = jsk.sinkhorn_knopp(j(f[v]), j(head), queue=j(queue[qv]), valid=j(np.ones(v.sum(), bool)),
                             queue_valid=j(np.ones(qv.sum(), bool)))
    _close(got[t(v)], ref, tol, "masked rows against the valid rows alone")
    assert torch.isfinite(got).all() and (got[t(~v)] == 0).all()
    np.testing.assert_allclose(_np(got)[v].sum(1), 1.0, atol=1e-5)
    _close(_jax_sinkhorn_valid_rows(j(f), j(head), valid=j(v), queue=j(queue),
                                    queue_valid=j(qv))[v], ref, tol, "the JAX twin")
    none = tsk.sinkhorn_knopp(t(f), t(head), valid=t(np.zeros(40, bool)), queue=t(queue),
                              queue_valid=t(np.zeros(16, bool)))
    _eq(none, np.asarray(jsk.sinkhorn_knopp(j(f), j(head), valid=j(np.zeros(40, bool)),
                                            queue=j(queue), queue_valid=j(np.zeros(16, bool)))))
    assert (none == 0).all() and (none.argmax(dim=-1) == 0).all()

    _close(tsk.sinkhorn_knopp_weighted(t(f), t(head), t(logw)),
           jsk.sinkhorn_knopp_weighted(j(f), j(head), j(logw)), tol)
    got = tsk.sinkhorn_knopp_weighted(t(f), t(head), t(logw), valid=t(v))
    _close(got[t(v)], jsk.sinkhorn_knopp_weighted(j(f[v]), j(head), j(logw)), tol)
    assert (got[t(~v)] == 0).all()

    for args, sl in (((f, head), slice(None)), ((f[v], head), None)):
        jq, jm = jsk.balanced_sinkhorn(j(args[0]), j(args[1]))
        if sl is None:  # the port on all rows with the mask
            tq, tm = tsk.balanced_sinkhorn(t(f), t(head), valid=t(v))
            assert torch.isfinite(tq).all() and (tq[t(~v)] == 0).all()
            tq = tq[t(v)]
        else:
            tq, tm = tsk.balanced_sinkhorn(t(args[0]), t(args[1]))
        _close(tq, jq, 1e-4, "balanced q")
        _close(tm, jm, 1e-4, "balanced marginal")

    logits = rng.normal(size=(30, 4)).astype(np.float32) * 2
    sv = rng.random(30) < 0.8
    for valid in (None, sv):
        jout = jsk.semi_sinkhorn_knopp(j(logits), None if valid is None else j(valid), num_iters=40)
        tout = tsk.semi_sinkhorn_knopp(t(logits), None if valid is None else t(valid),
                                       num_iters=40)
        for a, b in zip(tout, jout):
            _close(a, b, 1e-4)


def test_lion_losses_match_jax():
    """The six functions of `losses_lion`, f32 logits with an OOD column at
    17 and targets covering void, class 0, known and OOD rows; bf16 logits
    give the f32 result of the same values, finite, gradients included."""
    rng = np.random.default_rng(1)
    n, c, ood = 400, 18, 17
    logits = (rng.normal(size=(n, c)) * 3).astype(np.float32)
    targets = rng.integers(-1, c, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    details = rng.integers(0, 24, n).astype(np.int32)
    nbr = rng.integers(-1, n, size=(n, 27)).astype(np.int32)
    energy = (rng.normal(size=n) * 4).astype(np.float32)
    j, t = jnp.asarray, _t
    L, T, V = j(logits), t(logits), t(valid)
    cases = [
        (jlion.energy_of(L, ood), tlion.energy_of(T, ood)),
        (jlion.energy_of(L, ood, 2.0), tlion.energy_of(T, ood, 2.0)),
        (jlion.smooth_reg(j(energy), j(nbr), j(valid)),
         tlion.smooth_reg(t(energy), t(nbr), V)),
        (jlion.sparsity_reg(j(energy), j(valid)), tlion.sparsity_reg(t(energy), V)),
        (jlion.sparsity_reg(j(energy), j(np.zeros(n, bool))),
         tlion.sparsity_reg(t(energy), t(np.zeros(n, bool)))),
        (jlion.gambler_loss(L, j(targets), j(valid), ood, 4.5),
         tlion.gambler_loss(T, t(targets), V, ood, 4.5)),
        (jlion.gambler_loss(L, j(targets), j(valid), ood, 4.5, has_ood=False),
         tlion.gambler_loss(T, t(targets), V, ood, 4.5, has_ood=False)),
        (jlion.gambler_loss(L, j(targets), j(valid), 5, 60.0, ood_reg=0.3),
         tlion.gambler_loss(T, t(targets), V, 5, 60.0, ood_reg=0.3)),
    ]
    for nb in (None, nbr):
        for tg in (targets, np.where(targets == ood, 3, targets)):  # with and without OOD rows
            jl_, je = jlion.energy_loss(L, j(tg), j(valid), ood, None if nb is None else j(nb))
            tl_, te = tlion.energy_loss(T, t(tg), V, ood, None if nb is None else t(nb))
            cases += [(jl_, tl_), (je, te)]
            jl_, je = jlion.crude_dynamic_energy_loss(L, j(tg), j(valid), j(details), ood,
                                                      nbr=None if nb is None else j(nb))
            tl_, te = tlion.crude_dynamic_energy_loss(T, t(tg), V, t(details), ood,
                                                      nbr=None if nb is None else t(nb))
            cases += [(jl_, tl_), (je, te)]
    for jv, tv in cases:
        _close(tv, jv, 1e-5)

    x = T.bfloat16().requires_grad_()
    g = tlion.gambler_loss(x, t(targets), V, ood, 4.5)
    e, _ = tlion.energy_loss(x, t(targets), V, ood)
    assert g.dtype == e.dtype == torch.float32
    np.testing.assert_allclose(float(g.detach()), float(jlion.gambler_loss(
        j(_np(x.detach().float())), j(targets), j(valid), ood, 4.5)), rtol=1e-5)
    (g + e).backward()
    assert torch.isfinite(x.grad.float()).all()


def test_lookup_quantize_and_batched_coordinates_bit_equal():
    """`lookup_sorted` on present, absent, sentinel and past-the-end keys;
    `sparse_quantize` on points with faces at multiples of the voxel size
    (where a reciprocal product and a divide disagree), padding rows and a
    capacity under the voxel count, and on a capacity over it;
    `batched_coordinates`."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-3, 3, size=(3000, 3)).astype(np.float32)
    faces = (rng.integers(-60, 60, size=(1000, 3)) * np.float32(0.05)).astype(np.float32)
    pts = np.concatenate([pts, faces, faces + np.float32(1e-7)])
    bidx = rng.integers(0, 3, len(pts)).astype(np.int32)
    valid = rng.random(len(pts)) < 0.9
    for cap in (1500, 6000):
        jv = jvox.sparse_quantize(jnp.asarray(pts), jnp.asarray(bidx), jnp.asarray(valid), 0.05,
                                  cap)
        tv = tvox.sparse_quantize(_t(pts), _t(bidx), _t(valid), 0.05, cap)
        for k in ("coords", "valid", "rep", "inverse", "count"):
            _eq(tv[k], jv[k], k)
        for a, b in zip(tv["keys"], jv["keys"]):
            _eq(a, b)
    assert int(tv["count"]) > 1500  # the first capacity dropped voxels
    uh, ul = jv["keys"]
    present = np.flatnonzero(np.asarray(jv["valid"]))
    qh = np.concatenate([np.asarray(uh)[present], np.asarray(uh)[present] + 1,
                         [jco.SENTINEL_HI, np.iinfo(np.int32).max - 1, 0]]).astype(np.int32)
    ql = np.concatenate([np.asarray(ul)[present], np.asarray(ul)[present],
                         [jco.SENTINEL_LO, 5, 0]]).astype(np.int32)
    for shape in ((-1,), (3, -1)):
        qh2, ql2 = qh[: len(qh) // 3 * 3].reshape(shape), ql[: len(ql) // 3 * 3].reshape(shape)
        jl_ = jco.lookup_sorted(uh, ul, jnp.asarray(qh2), jnp.asarray(ql2))
        tl_ = tco.lookup_sorted(_t(uh), _t(ul), _t(qh2), _t(ql2))
        _eq(tl_, jl_)
    assert (_np(tl_) >= 0).any() and (_np(tl_) == -1).any()
    clouds = [rng.integers(-9, 9, size=(n, 3)) for n in (4, 0, 7)]
    _eq(tvox.batched_coordinates(clouds), jvox.batched_coordinates(clouds))


def test_lasermix_pair_and_batch_match_jax():
    rng = np.random.default_rng(3)
    s, p = 2, 600
    xyz = np.concatenate([rng.normal(size=(2 * s, p, 2)) * 20,
                          rng.uniform(-4, 1, size=(2 * s, p, 1))], -1).astype(np.float32)
    feats = rng.normal(size=(2 * s, p, 2)).astype(np.float32)
    labels = rng.integers(-1, 17, size=(2 * s, p)).astype(np.int32)
    valid = rng.random((2 * s, p)) < 0.85
    pseudo = rng.integers(-1, 19, size=(s, p)).astype(np.int32)

    def side(lo, arr_fn):
        return {"xyz": arr_fn(xyz[lo:lo + s]), "feats": arr_fn(feats[lo:lo + s]),
                "mapped_labels": arr_fn(labels[lo:lo + s]), "valid": arr_fn(valid[lo:lo + s])}

    for na in (3, 4, 5, 6):
        jb = jlm.lasermix_batch(side(0, jnp.asarray), side(s, jnp.asarray), jnp.asarray(pseudo),
                                jnp.asarray(na, jnp.int32))
        tb = tlm.lasermix_batch(side(0, _t), side(s, _t), _t(pseudo),
                                torch.tensor(na, dtype=torch.int32))
        for a, b in zip(tb, jb):
            _eq(a, b, na)
        one = {"xyz": xyz[0], "feats": feats[0], "labels": labels[0], "valid": valid[0]}
        two = {"xyz": xyz[s], "feats": feats[s], "labels": pseudo[0], "valid": valid[s]}
        jp = jlm.lasermix_pair({k: jnp.asarray(v) for k, v in one.items()},
                               {k: jnp.asarray(v) for k, v in two.items()},
                               jnp.asarray(na, jnp.int32))
        tp = tlm.lasermix_pair({k: _t(v) for k, v in one.items()},
                               {k: _t(v) for k, v in two.items()},
                               torch.tensor(na, dtype=torch.int32))
        assert set(tp) == set(jp)
        for k in jp:
            _eq(tp[k], jp[k], k)
        assert not (_np(tp["mix1"]) & _np(tp["mix2"])).any()


def test_mixed_plan_point_matches_voxel_mode_and_jax():
    """The port's twin of `test_discover_e2e.py::test_mixed_plan_voxel_
    matches_point_oracle`: on a geometry with no voxel near a band edge, the
    point-mode plan (`_mixed_plan_point`) equals the voxel-mode one
    (`_mixed_plan_voxel`): level-0 coords and valid, k3 and k5 maps,
    features, labels. The point-mode plan also equals the JAX package's bit
    for bit, features and labels included."""
    rng = np.random.default_rng(7)
    vsize = 0.05
    down, up = -25.0 / 180 * np.pi, 3.0 / 180 * np.pi
    edges = np.unique(np.concatenate([down + np.arange(na + 1) * (up - down) / na
                                      for na in (3, 4, 5, 6)]))

    def make_scan(n, seed_off):
        r = np.random.default_rng(7 + seed_off)
        pts = []
        while sum(len(q) for q in pts) < n:
            pitch = r.uniform(down + 0.01, up - 0.01, size=4 * n)
            # >= 0.6 degrees from every band edge: a 0.05 m voxel at <= 40 m
            # subtends < 0.1 degrees, so point and voxel-center parity agree
            pitch = pitch[np.abs(pitch[:, None] - edges[None, :]).min(1) > 0.6 / 180 * np.pi]
            rad = r.uniform(5.0, 40.0, size=pitch.shape[0])
            yaw = r.uniform(-np.pi, np.pi, size=pitch.shape[0])
            rho = rad * np.cos(pitch)
            pts.append(np.stack([rho * np.cos(yaw), rho * np.sin(yaw), rad * np.sin(pitch)], 1))
        return np.concatenate(pts)[:n].astype(np.float32)

    P, capx = 600, 1536
    caps = (capx, 1024, 512, 256, 256)
    scans = []
    for s in range(2):  # one sup and one unsup scan
        pts = make_scan(P, s)
        vox, sel, _ = sparse_quantize_np(pts, vsize)
        m = vox.shape[0]
        xyz = np.zeros((P, 3), np.float32)
        xyz[:m] = pts[sel]  # one point a voxel
        feats = np.zeros((P, 1), np.float32)
        feats[:m, 0] = rng.normal(size=m)
        labels = np.full(P, -1, np.int32)
        labels[:m] = rng.integers(0, 17, size=m)
        scans.append(dict(coords=vox, m=m, xyz=xyz, valid=np.arange(P) < m, feats=feats,
                          labels=labels))
    sup, uns = scans
    sup_cap = capx // 2
    coords = np.zeros((capx, 4), np.int32)
    feats_in = np.zeros((capx, 1), np.float32)
    mapped_in = np.full(capx, -1, np.int32)
    valid_in = np.zeros(capx, bool)
    coords[:sup["m"], 1:] = sup["coords"]
    coords[sup_cap:sup_cap + uns["m"], 0] = 1
    coords[sup_cap:sup_cap + uns["m"], 1:] = uns["coords"]
    feats_in[:sup["m"]] = sup["feats"][:sup["m"]]
    feats_in[sup_cap:sup_cap + uns["m"]] = uns["feats"][:uns["m"]]
    mapped_in[:sup["m"]] = sup["labels"][:sup["m"]]
    valid_in[:sup["m"]] = True
    valid_in[sup_cap:sup_cap + uns["m"]] = True

    plan = tplan.build_unet_plan(_t(coords), _t(valid_in), caps, presorted=True)
    rep = _np(plan.rep)
    ok = rep < capx
    safe = np.where(ok, rep, 0)
    feats0 = _t(np.where(ok[:, None], feats_in[safe], 0.0))
    mapped0 = _t(np.where(ok, mapped_in[safe], -1))
    is_sup = _t(ok & (rep < sup_cap))
    lvl_valid, lvl_coords = _np(plan.levels[0].valid), _np(plan.levels[0].coords)
    pseudo_vox = np.where(lvl_valid & ~_np(is_sup),
                          np.random.default_rng(3).integers(-1, 18, size=capx), -1).astype(np.int32)
    row_of = {tuple(c): i for i, c in enumerate(lvl_coords) if lvl_valid[i]}
    pseudo_pts = np.full((1, P), -1, np.int32)
    for jj in range(uns["m"]):
        row = row_of.get((1, *uns["coords"][jj]))
        if row is not None:
            pseudo_pts[0, jj] = pseudo_vox[row]

    def pb(scan, lab, arr):
        return {"xyz": arr(scan["xyz"][None]), "feats": arr(scan["feats"][None]),
                "mapped_labels": arr(lab[None]), "valid": arr(scan["valid"][None])}

    kw = dict(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19, unknown_label=17,
              voxel_caps=caps, sup_voxel_cap=sup_cap, mix_voxel_caps=caps, num_sup_scans=1,
              point_cap=P, voxel_size=vsize)
    tcfg, jcfg = td.DiscoverConfig(**kw), jd.DiscoverConfig(**kw)
    for na in (3, 4, 5, 6):
        tna = torch.tensor(na, dtype=torch.int32)
        plan_p, feats_p, labels_p = td._mixed_plan_point(
            tcfg, pb(sup, sup["labels"], _t), pb(uns, uns["labels"], _t), _t(pseudo_pts), tna)
        plan_v, feats_v, labels_v = td._mixed_plan_voxel(tcfg, plan, feats0, mapped0, is_sup,
                                                         _t(pseudo_vox), tna)
        v = _np(plan_v.levels[0].valid)
        _eq(plan_p.levels[0].valid, v, na)
        for a, b in ((plan_p.levels[0].coords, plan_v.levels[0].coords),
                     (plan_p.levels[0].nbr3, plan_v.levels[0].nbr3),
                     (plan_p.stem_nbr, plan_v.stem_nbr), (feats_p, feats_v),
                     (labels_p, labels_v)):
            _eq(_np(a)[v], _np(b)[v], na)
        if na == 4:
            jp = jax.jit(lambda a, b, c, d: jd._mixed_plan_point(jcfg, a, b, c, d))(
                pb(sup, sup["labels"], jnp.asarray), pb(uns, uns["labels"], jnp.asarray),
                jnp.asarray(pseudo_pts), jnp.asarray(na, jnp.int32))
            for a, b in ((plan_p.levels[0].coords, jp[0].levels[0].coords),
                         (plan_p.levels[0].valid, jp[0].levels[0].valid),
                         (plan_p.stem_nbr, jp[0].stem_nbr), (plan_p.rep, jp[0].rep),
                         (feats_p, jp[1]), (labels_p, jp[2])):
                _eq(a, b, "against JAX")


def test_semantic_eval_and_ioueval_match_jax():
    rng = np.random.default_rng(4)
    jse, tse = jmet.SemanticEval(19, ignore=(0, 5)), tmet.SemanticEval(19, ignore=(0, 5))
    jio, tio = jioue.IoUEval(19, ignore=0, unknown=17), tioue.IoUEval(19, ignore=0, unknown=17)
    jplain, tplain = jioue.IoUEval(19), tioue.IoUEval(19)
    for _ in range(3):
        preds = rng.integers(-2, 21, 500)
        labels = rng.integers(-1, 20, 500)
        scores = rng.random(500).astype(np.float32)
        for a, b in ((jse, tse),):
            a.add_batch(preds, labels)
            b.add_batch(preds, labels)
        for a, b in ((jio, tio), (jplain, tplain)):
            a.add_batch(preds, labels, scores)
            b.add_batch(preds, labels, scores)
    _eq(tse.conf, jse.conf)
    for a, b in ((tse.get_sem_iou(), jse.get_sem_iou()), (tio.get_iou(), jio.get_iou()),
                 (tplain.get_iou(), jplain.get_iou())):
        assert a[0] == b[0]
        _eq(a[1], b[1])
    assert tse.get_sem_acc() == jse.get_sem_acc() and tio.get_acc() == jio.get_acc()
    _eq(tio.get_confusion(), jio.get_confusion())
    for a, b in ((tio.get_unknown_score_stats(), jio.get_unknown_score_stats()),
                 (tplain.get_unknown_score_stats(), jplain.get_unknown_score_stats())):
        assert set(a) == set(b)
        for k in b:
            _eq(a[k], b[k], k)
    tse.reset()
    tio.reset()
    assert tse.conf.sum() == 0 and tio.conf.sum() == 0 and tio.known_scores == []


def _blobs(rng, n, k, c, spread=0.3):
    centers = rng.normal(size=(k, c)) * 4
    lab = rng.integers(0, k, n)
    return (centers[lab] + spread * rng.normal(size=(n, c))).astype(np.float32), lab


def test_euclidean_kmeans_matches_jax():
    rng = np.random.default_rng(5)
    x, _ = _blobs(rng, 500, 6, 8)
    valid = rng.random(500) < 0.8
    key = jax.random.PRNGKey(4)
    for iters in (1, 8, 20):
        ja, jc = jkm.euclidean_kmeans(jnp.asarray(x), jnp.asarray(valid), 7, key, iters=iters)
        ta, tc = tkm.euclidean_kmeans(_t(x), _t(valid), 7, _t(jax.random.uniform(key, (500,))),
                                      iters=iters)
        _eq(ta, ja, iters)
        _close(tc, jc, 1e-5, iters)


def _jax_picks(x, centers, n_pre):
    """Row of `x` that each center after the first `n_pre` was copied from."""
    x, centers = np.asarray(x), np.asarray(centers)
    out = []
    for c in centers[n_pre:]:
        hit = np.flatnonzero((x == c).all(1))
        assert hit.size >= 1
        out.append(int(hit[0]))
    return out


def _relabelling(a, b):
    """{label in `a`: label in `b`} where the two labellings are one
    partition of the rows, else None."""
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    m = dict(pairs)
    return m if len(m) == len(pairs) == len(set(m.values())) else None


def test_clustering_matches_jax():
    """`pairwise_distance`; `kmeans_pp_init` (plain and anchored) with the
    JAX package's k-means++ picks; `OnlineSemiKMeans.fit` / `fit_mix` with
    them (each restart alone, then the kept run: JAX's where its restarts
    differ in partition, else the first of the port's exactly tied restarts);
    `SemiSupervisedStreamKM` with the JAX package's k-means draws. The port's
    own draws give centers among the valid rows."""
    rng = np.random.default_rng(6)
    x, _ = _blobs(rng, 300, 5, 6)
    valid = rng.random(300) < 0.9
    y = rng.normal(size=(40, 6)).astype(np.float32)
    _close(tclu.pairwise_distance(_t(x), _t(y)), jclu.pairwise_distance(jnp.asarray(x),
                                                                     jnp.asarray(y)), 1e-5)
    key = jax.random.PRNGKey(1)
    jc = jclu.kmeans_pp_init(key, jnp.asarray(x), jnp.asarray(valid.astype(np.float32)), 5)
    tc = tclu.kmeans_pp_init(_t(x), _t(valid), 5, picks=_jax_picks(x, jc, 0))
    _eq(tc, jc)
    anchors = x[:3] + 0.5
    jc = jclu.kmeans_pp_init(key, jnp.asarray(x), jnp.asarray(valid.astype(np.float32)), 6,
                             pre_centers=jnp.asarray(anchors))
    tc = tclu.kmeans_pp_init(_t(x), _t(valid), 6, pre_centers=_t(anchors),
                             picks=_jax_picks(x, jc, 3))
    _eq(tc, jc)
    own = tclu.kmeans_pp_init(_t(x), _t(valid), 5, generator=torch.Generator().manual_seed(0))
    assert all((_np(own)[i] == x[valid]).all(1).any() for i in range(5))

    picks = [_jax_picks(x, jclu.kmeans_pp_init(jax.random.PRNGKey(3 + i), jnp.asarray(x),
                                               jnp.ones(300, jnp.float32), 5), 0)
             for i in range(2)]
    # each restart alone against the JAX restart with the same picks
    jruns = [jclu.OnlineSemiKMeans(k=5, max_iterations=30, n_init=1, seed=3 + i).fit(x)
             for i in range(2)]
    truns = [tclu.OnlineSemiKMeans(k=5, max_iterations=30, n_init=1, seed=3 + i).fit(x, picks=[p])
             for i, p in enumerate(picks)]
    for i, (t, j) in enumerate(zip(truns, jruns)):
        _eq(t.labels_, j.labels_, f"restart {i}: labels")
        _close(t.cluster_centers_, j.cluster_centers_, 1e-5, f"restart {i}: centres")
    # the kept run: the first restart of least inertia on both sides
    jkmeans = jclu.OnlineSemiKMeans(k=5, max_iterations=30, n_init=2, seed=3).fit(x)
    tkmeans = tclu.OnlineSemiKMeans(k=5, max_iterations=30, n_init=2, seed=3).fit(x, picks=picks)
    if _relabelling(jruns[0].labels_, jruns[1].labels_) is None:
        _eq(tkmeans.labels_, jkmeans.labels_, "kept run, restarts of two partitions")
        _close(tkmeans.cluster_centers_, jkmeans.cluster_centers_, 1e-5, "kept run: centres")
    else:
        # One partition under two numberings. The restarts converged, so the
        # port's inertia is the partition's: they tie exactly and the first
        # is kept; the JAX restarts' f32 inertias (minimum over the distance
        # columns) may round apart and keep either, so the kept labels are
        # JAX's up to the permutation that maps one numbering onto the other.
        assert tkmeans.inertias_[0] == tkmeans.inertias_[1], (
            f"restarts of one partition, inertias {tkmeans.inertias_}")
        _eq(tkmeans.labels_, truns[0].labels_, "kept run of tied restarts: not the first")
        perm = _relabelling(tkmeans.labels_, jkmeans.labels_)
        assert perm is not None, "kept run: not JAX's partition"
        assert set(perm) == set(perm.values()) == set(range(5)), f"kept run: labels {perm}"

    lx, lt = _blobs(np.random.default_rng(7), 200, 3, 6)
    ux = np.concatenate([lx[:80] + 0.05, _blobs(np.random.default_rng(8), 120, 2, 6)[0]])
    jm = jclu.OnlineSemiKMeans(k=5, max_iterations=30, n_init=1, seed=2)
    jlabels = jm.fit_mix(ux, lx, lt)
    lt_j = jnp.asarray(lt, jnp.int32)
    onehot = jax.nn.one_hot(lt_j, 3)
    jan = (onehot.T @ jnp.asarray(lx)) / jnp.maximum(jnp.sum(onehot, axis=0)[:, None], 1.0)
    jc = jclu.kmeans_pp_init(jax.random.PRNGKey(2), jnp.asarray(ux), jnp.ones(200, jnp.float32),
                             5, pre_centers=jan)
    tm = tclu.OnlineSemiKMeans(k=5, max_iterations=30, n_init=1, seed=2)
    tlabels = tm.fit_mix(ux, lx, lt, picks=[_jax_picks(ux, jc, 3)])
    _eq(tlabels, jlabels)
    _close(tm.cluster_centers_, jm.cluster_centers_, 1e-5)
    _close(tm.fit_mix(ux, lx, lt, center_only=True, picks=[_jax_picks(ux, jc, 3)]),
           jm.cluster_centers_, 1e-5)

    jstream = jclu.SemiSupervisedStreamKM(4, coreset_size=50, batch_size=6, seed=5)
    tstream = tclu.SemiSupervisedStreamKM(4, coreset_size=50, batch_size=6, seed=5)
    for i, (data, lab) in enumerate(((x[:60], None), (lx[:30], lt[:30]), (x[60:100], None))):
        jstream.partial_fit(data, lab)
        scores = (None if lab is not None else
                  jax.random.uniform(jax.random.PRNGKey(5 + jstream._calls), (data.shape[0],)))
        tstream.partial_fit(data, lab, scores=scores)
    _close(np.stack(tstream.coreset), np.stack(jstream.coreset), 1e-5)
    n = len(jstream.coreset)
    _close(tstream.get_cluster_centers(scores=jax.random.uniform(jax.random.PRNGKey(5), (n,))),
           jstream.get_cluster_centers(), 1e-5)


def test_clustering_eval_matches_jax():
    """`clustering_discovery_eval` with `semi_kmeans` (JAX's k-means++
    picks) and `sinkhorn` (JAX's k-means draw), and `extract_features` over
    a loader of tensors."""
    rng = np.random.default_rng(9)
    meta = dataset_meta("SemanticKITTI")
    unknown, _ = split_table("SemanticKITTI", 1)
    mapping, inv, unk = build_label_mapping(unknown, meta["learning_map_inv"].keys())
    known_real = [k for k, v in mapping.items() if v != unk]
    unknown_real = [k for k, v in mapping.items() if v == unk]
    feats, lab = _blobs(rng, 900, 19, 8, spread=0.5)
    real = lab.astype(np.int32)
    mapped_labels = np.where(np.isin(lab, unknown_real), unk, lab % 17).astype(np.int32)
    common = (feats, mapped_labels, real, unk, known_real, unknown_real, 19, inv)

    jr = jce.clustering_discovery_eval(*common, method="semi_kmeans", seed=1)
    is_u = mapped_labels == unk
    u, lf, lt = feats[is_u], feats[~is_u], mapped_labels[~is_u]
    lt_j = jnp.asarray(lt, jnp.int32)
    n_lab = int(lt.max()) + 1
    onehot = jax.nn.one_hot(lt_j, n_lab)
    jan = (onehot.T @ jnp.asarray(lf)) / jnp.maximum(jnp.sum(onehot, axis=0)[:, None], 1.0)
    jc = jclu.kmeans_pp_init(jax.random.PRNGKey(1), jnp.asarray(u),
                             jnp.ones(u.shape[0], jnp.float32), n_lab + len(unknown_real),
                             pre_centers=jan)
    tr = tce.clustering_discovery_eval(*common, method="semi_kmeans", seed=1, device="cpu",
                                       picks=_jax_picks(u, jc, n_lab))
    jr2 = jce.clustering_discovery_eval(*common, method="sinkhorn", seed=4)
    tr2 = tce.clustering_discovery_eval(
        *common, method="sinkhorn", seed=4, device="cpu",
        scores=jax.random.uniform(jax.random.PRNGKey(4), (u.shape[0],)))
    for a, b in ((tr, jr), (tr2, jr2)):
        _eq(a["conf"], b["conf"])
        for k in ("mIoU", "mIoU_old", "mIoU_new"):
            assert a[k] == b[k], k
        _eq(a["iou"], b["iou"])
    assert jr["conf"].sum() == len(real)
    with pytest.raises(ValueError):
        tce.clustering_discovery_eval(*common, method="dbscan", device="cpu")
    if not torch.cuda.is_available():  # the card by default, and no card here
        with pytest.raises(RuntimeError, match="CUDA"):
            tce.clustering_discovery_eval(*common)

    batches = [(torch.randn(50, 4), torch.arange(50), torch.arange(50) % 7, torch.rand(50) < 0.6)
               for _ in range(3)]
    kw = dict(feat_dim=4)
    tf = tce.extract_features(lambda b: b, batches, **kw)
    jf = jce.extract_features(lambda b: tuple(x.numpy() for x in b), batches, **kw)
    for a, b in zip(tf, jf):
        _eq(a, b)
    first = tce.extract_features(lambda b: b, batches, max_voxels=1, **kw)
    assert first[0].shape[0] == int(batches[0][3].sum())


# ------------------------------------------------------------- the steps


def _jax_draws(rng_key, cfg):
    """The draws `_discover_step_impl` takes from state.rng: LaserMix's
    `num_areas`, the k-means scores and, with feature mixing, the two
    permutations `mix_features` draws from `k_featmix`."""
    _, k_kmeans, k_areas, k_featmix = jax.random.split(rng_key, 4)
    n = min(cfg.cand_cap, cfg.voxel_caps[0]) + cfg.queue_slots * cfg.queue_per_slot
    draws = {"num_areas": _t(jax.random.choice(k_areas, jnp.asarray([3, 4, 5, 6], jnp.int32))),
             "kmeans_scores": _t(jax.random.uniform(k_kmeans, (n,)))}
    if cfg.mix_mode == "feature":
        k1, k2, _ = jax.random.split(k_featmix, 3)
        cap0 = cfg.voxel_caps[0]
        draws["featmix_perms"] = (_t(jax.random.permutation(k1, cap0)),
                                  _t(jax.random.permutation(k2, cap0)))
    return draws


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """Batches (JAX-collated; points included), the validation batch, the
    label space and one JAX initial state as numpy trees: its zero tensors
    drawn from a seed, its NCC bias raised (`raise_ncc`), the teacher a copy
    of the student."""
    root = str(tmp_path_factory.mktemp("kitti_variants"))
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
    dskw = dict(voxel_size=0.15, label_mapping=mapping, unknown_labels=unknown)
    lab = SemanticKITTIDataset(root, "train", split_indices=np.array([0, 1]), labeled=True,
                               downsampling=800, augment=True, resize_aug=True, seed=0, **dskw)
    unlab = SemanticKITTIDataset(root, "train", split_indices=np.array([0, 1]), labeled=False,
                                 downsampling=800, augment=True, seed=1, **dskw)
    val_ds = SemanticKITTIDataset(root, "valid", **dskw)
    sup = collate_batch([lab[0], lab[1]], SUP_CAP, point_cap=POINT_CAP)
    unsup = collate_batch([unlab[0], unlab[1]], CAPS[0] - SUP_CAP, point_cap=POINT_CAP)
    val = collate_batch([val_ds[0], val_ds[1]], CAPS[0], point_cap=1024)
    unknown_real = [k for k, v in mapping.items() if v == unk]
    lut = jcommon.inv_label_lut(inv, 19, {unk + i: r for i, r in enumerate(unknown_real)})
    jcfg = jd.DiscoverConfig(**kw)
    jstate = jax.tree_util.tree_map(np.asarray, jd.create_discover_state(jax.random.PRNGKey(0),
                                                                         jcfg))

    def raise_ncc(params):
        """The NCC heads' bias up by NCC_BIAS: the teacher's NCC probability
        passes `fixed_prob`'s 0.2 on enough rows for the novel branch to fire."""
        params = dict(params)
        params["final2"] = {**params["final2"], "bias": params["final2"]["bias"] + NCC_BIAS}
        return params

    # every zero tensor of the initial state (biases, batch-norm shifts)
    # drawn away from 0: a tensor compared at 1e-4 of its own magnitude must
    # not be one step's update alone, whose gradient sums cancel to below
    # their summation-order noise at that scale
    draw = np.random.default_rng(12)
    params = jax.tree_util.tree_map(
        lambda a: (draw.normal(0, 0.05, a.shape).astype(a.dtype) if not a.any() else a),
        jstate.params_s)
    params = raise_ncc(params)
    jstate = jstate.replace(params_s=params, params_t=params)
    return dict(kw=kw, sup=sup, unsup=unsup, val=val, lut=lut, jcfg=jcfg, jstate=jstate)


def _trees(state) -> dict:
    return jax.tree_util.tree_map(np.asarray, dict(
        params_s=state.params_s, batch_stats_s=state.batch_stats_s, params_t=state.params_t,
        batch_stats_t=state.batch_stats_t, tau=state.tau, queue=tuple(state.queue),
        step=state.step))


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, base):
    """Two JAX steps of the config and the port's two from the same state,
    batches and draws, and both eval-step confusions after them."""
    name, extra = VARIANTS[request.param]
    overrides = {**resolve_discover_overrides(name, "SemanticKITTI"), **extra}
    jcfg = jd.DiscoverConfig(**{**base["kw"], **overrides})
    tcfg = td.DiscoverConfig(**{**base["kw"], **overrides})
    jstate = jax.tree_util.tree_map(jnp.asarray, base["jstate"])
    jstate = jstate.replace(tau=jnp.asarray(jcfg.tau_init, jnp.float32))
    tree0 = _trees(jstate)
    sup, unsup = base["sup"], base["unsup"]
    jb = [jcommon.voxel_batch_to_device(sup["voxel"]),
          jcommon.point_batch_to_device(sup["points"]),
          jcommon.voxel_batch_to_device(unsup["voxel"]),
          jcommon.point_batch_to_device(unsup["points"])]
    jsteps = []
    with pytest.MonkeyPatch.context() as mp:
        if jcfg.assigner == "sinkhorn":
            mp.setattr(jsk, "sinkhorn_knopp", _jax_sinkhorn_valid_rows)
        for _ in range(2):
            draws = _jax_draws(jstate.rng, jcfg)
            jstate, jm = jd.discover_train_step(jstate, *jb, jcfg)
            jsteps.append(dict(draws=draws, metrics={k: np.asarray(v) for k, v in jm.items()},
                               state=_trees(jstate)))
    lut = base["lut"]
    jconf = np.asarray(jd.discover_eval_step(
        jstate, jcommon.voxel_batch_to_device(base["val"]["voxel"]),
        jcommon.point_batch_to_device(base["val"]["points"]), jnp.asarray(lut), base["jcfg"]))

    tstate = td.create_discover_state(0, tcfg, device="cpu")
    load_jax_discover_state(tstate, tree0)
    tb = dict(sup_vb=tcommon.voxel_batch_to_device(sup["voxel"], "cpu"),
              unsup_vb=tcommon.voxel_batch_to_device(unsup["voxel"], "cpu"),
              sup_pb=tcommon.point_batch_to_device(sup["points"], "cpu"),
              unsup_pb=tcommon.point_batch_to_device(unsup["points"], "cpu"))
    tsteps = []
    for js in jsteps:
        tstate, tm = td.discover_train_step(tstate, cfg=tcfg, draws=js["draws"], **tb)
        tsteps.append(dict(metrics=tm, tau=float(tstate.tau.detach()),
                           student={k: v.detach().clone()
                                    for k, v in tstate.student.state_dict().items()},
                           teacher={k: v.detach().clone()
                                    for k, v in tstate.teacher.state_dict().items()},
                           queue=tuple(a.clone() for a in tstate.queue)))
    tconf = td.discover_eval_step(
        tstate, tcommon.voxel_batch_to_device(base["val"]["voxel"], "cpu"),
        tcommon.point_batch_to_device(base["val"]["points"], "cpu"), torch.as_tensor(lut), tcfg)
    return dict(name=request.param, jsteps=jsteps, tsteps=tsteps, jconf=jconf, tconf=tconf)


def test_variant_steps_match_jax(variant):
    """Both steps' metrics (loss terms and tau within rtol 1e-5, counts
    exact), the student and teacher parameters with their batch-norm
    statistics, tau and the queue after each step, and the eval-step
    confusion after both."""
    for i, (js, ts) in enumerate(zip(variant["jsteps"], variant["tsteps"])):
        jm, tm = js["metrics"], ts["metrics"]
        for k in LOSS_KEYS + ("tau",):
            assert np.isfinite(float(tm[k])), (i, k)
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        for k in COUNT_KEYS:
            assert int(tm[k]) == int(jm[k]), (i, k)
        assert int(tm["n_cand"]) > 0, i
        if variant["name"] in MUST_FIRE:
            assert int(tm["has_novel"]) == 1, i
        np.testing.assert_allclose(ts["tau"], float(js["state"]["tau"]), rtol=1e-5, atol=1e-7)
        for who, side in (("student", "s"), ("teacher", "t")):
            ref = jax_to_state_dict(js["state"][f"params_{side}"],
                                    js["state"][f"batch_stats_{side}"])
            assert set(ref) == set(ts[who])
            for k, v in ref.items():
                _close(ts[who][k], v, 1e-4, f"step {i} {who} {k}")
        jq, tq = js["state"]["queue"], ts["queue"]
        _close(tq[0], jq[0], 1e-4, "queue feats")
        _eq(tq[1], jq[1], "queue counts")
        _eq(tq[2], jq[2], "queue head")
    assert int(variant["tconf"].sum()) > 0
    _eq(variant["tconf"], variant["jconf"])
