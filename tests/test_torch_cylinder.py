"""PyTorch port vs JAX package: the Cylinder3D stack on the CPU.

Live against the JAX package (its functions run eagerly or with one small
jit each):
  1. the asymmetric and strided books (`ops/asym`) and the cylinder plan,
     bit for bit, at strides (2, 2, 2) and (2, 2, 1), coordinate 0 on every
     axis included; `strided_gather_conv`; `paired_gather_conv` (output, dX, dW) against `jax.vjp`
     in both role orders, plain and through `fused_conv.pool_conv` (the
     model's route); each asymmetric subset's submanifold conv against the
     JAX `gather_conv` with its symmetric adjoint; `Cylinder3DHead`'s
     logits and loss;
  2. `ops/scatter` (voxel sets and inverse maps bit for bit, max and mean
     pooling with tied maxima and their gradients, `hard_voxelize`,
     `scatter_mean`, `cylindrical_coords` and the VFE's bins: no point
     changes bin on 20,000 random points), `lovasz_softmax` (value and
     gradient, ties among the errors) and `Voxelizer`'s four modes.
Against frozen goldens of the JAX package (`torch_cylinder_goldens.npz`: a
JAX Cylinder3D compile costs minutes on this CPU; `_jax_goldens` rebuilds
them from the JAX package, and the `slow` test
`test_cylinder_goldens_are_the_jax_package` holds the file to it):
  3. `MultiHeadCylinder3D` and `Cylinder3DRC` (base channels 8, caps <=
     2,048) forward in training mode and backward, weights carried across:
     the cylinder plan's books bit for bit, outputs, every gradient and the
     batch-norm statistics;
  4. two `cylinder_train_step`s and its eval confusion before and after
     them, and one Stage-2
     `discover_train_step` on Cylinder3D (base 32, as the JAX package
     builds it) with the JAX step's random draws injected: losses, counts,
     every parameter after SGD, the teacher and the queue.

Weights are drawn with numpy from a seed per state-dict key and carried into
the JAX trees (`utils.weights.cylinder_state_dict_to_jax`). A float golden
is a tensor's max |x|, its norm and its values at 32 fixed positions
(`_summary`); an integer one a digest. Tolerances: f32 on both sides, so
floats differ by summation order only: 1e-5 of a tensor's largest magnitude
for the ops; 1e-4 for the models' outputs, statistics and gradients, and
for the steps' losses; counts, books, queues' counts and the confusion of
the initial state exact.
Gradients are compared with batch norm in eval mode: in training mode, over
these few voxels, they are ill-conditioned (1e-6 relative noise on the
weights moves some by 30%, in the port alone), which is also why the
parameters and statistics after SGD are held to 2e-3 of their largest
magnitude (measured: 8e-4 after the trainer's two steps at lr 0.01, 4.5e-4
after the Stage-2 step), while the losses of the step after agree within
4e-5; that drift moves one point at an argmax tie in the confusion after
the two steps (at most 2 allowed).
"""

import hashlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcdlss_tpu.algo import queue as jq
from gcdlss_tpu.data import build_label_mapping, collate_batch, dataset_meta, split_table
from gcdlss_tpu.data import SemanticKITTIDataset, write_synthetic_kitti
from gcdlss_tpu.models import cylinder3d as jcyl
from gcdlss_tpu.models import voxelizer as jvox
from gcdlss_tpu.ops import asym as ja
from gcdlss_tpu.ops import conv as jconv
from gcdlss_tpu.ops import coords as jc
from gcdlss_tpu.ops import lovasz as jlv
from gcdlss_tpu.ops import scatter as jsc
from gcdlss_tpu.ops.plan import build_unet_plan as jax_build_unet_plan
from gcdlss_tpu.train import common as jcommon
from gcdlss_tpu.train import cylinder as jtc
from gcdlss_tpu.train import discover as jd
from gcdlss_tpu_torch.models import cylinder3d as tcyl
from gcdlss_tpu_torch.models.layers import SparseBatchNorm
from gcdlss_tpu_torch.models import voxelizer as tvox
from gcdlss_tpu_torch.ops import asym as ta
from gcdlss_tpu_torch.ops import conv as tconv
from gcdlss_tpu_torch.ops import lovasz as tlv
from gcdlss_tpu_torch.ops import scatter as tsc
from gcdlss_tpu_torch.ops.fused_conv import pool_conv, subm_conv
from gcdlss_tpu_torch.ops.plan import build_unet_plan
from gcdlss_tpu_torch.train import common as tcommon
from gcdlss_tpu_torch.train import cylinder as ttc
from gcdlss_tpu_torch.train import discover as td
from gcdlss_tpu_torch.utils.weights import (cylinder_jax_to_state_dict,
                                            cylinder_state_dict_to_jax,
                                            load_jax_discover_state)

GOLDENS = Path(__file__).with_name("torch_cylinder_goldens.npz")
OP_TOL = 1e-5
MODEL_TOL = 1e-4
STEP_TOL = 2e-3  # parameters and statistics after SGD (docstring)
STRIDES = ((2, 2, 2), (2, 2, 1))
PLAN_CAPS = (2048, 1024, 512, 256, 256)
GRID = (60, 45, 10)
MH_KW = dict(num_labeled=14, num_unlabeled=2, num_heads=2, overcluster_factor=3,
             base_channels=8, grid_shape=GRID, caps=PLAN_CAPS)
RC_CAP0 = 2048
RC_CAPS = (RC_CAP0, 1536, 1024, 512, 512)
S2_CAPS = (2048, 1536, 1024, 512, 512)
MH_KEYS = ("feats", "logits_lab", "logits_unlab", "logits_unlab_over")
RC_KEYS = ("feats", "logits_known", "logits_ncc", "logits_novel")
S2_SUP_CAP = 1024


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one CPU thread while this module's tests run
    (the suite runs several workers at once; each worker's default pool
    would oversubscribe the cores). Restored when the module's tests end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _eq(got, ref, what=""):
    np.testing.assert_array_equal(_np(got), np.asarray(ref), err_msg=what)


def _close(got, ref, tol=OP_TOL, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max(initial=0)), 1e-6),
                               err_msg=what)


# ------------------------------------------------------------ goldens


def _digest(a) -> str:
    a = np.ascontiguousarray(_np(a))
    a = a.astype(np.int32) if a.dtype != np.bool_ else a.astype(np.uint8)
    return hashlib.sha256(a.tobytes() + str(a.shape).encode()).hexdigest()[:32]


def _summary(a) -> np.ndarray:
    """max |a|, ||a|| and a's values at 32 positions fixed by its size (f32)."""
    a = np.asarray(_np(a), np.float64).ravel()
    pos = np.sort(np.random.default_rng(a.size).choice(a.size, min(32, a.size), replace=False))
    return np.concatenate([[np.abs(a).max(initial=0), np.linalg.norm(a)], a[pos]]).astype(
        np.float32)


def _match(got, ref: np.ndarray, tol: float, what: str) -> None:
    s = _summary(got)
    assert s.shape == ref.shape, (what, s.shape, ref.shape)
    scale = max(ref[0], 1e-6)
    assert abs(s[1] - ref[1]) <= tol * max(ref[1], 1e-6), (what, s[1], ref[1])
    err = float(np.abs(s[2:] - ref[2:]).max(initial=0))
    assert err <= tol * scale, (what, err, scale)


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
        if field in ("kernel", "pool_kernel", "up_kernel"):
            fan = shape[0] * shape[2] / 2.0 if len(shape) == 3 else shape[0]
            v = n / np.sqrt(fan)
        elif field == "weight":
            v = 1.0 + 0.1 * n
        elif field == "running_var":
            v = 1.0 + 0.2 * np.abs(n)
        else:  # bias, running_mean
            v = 0.1 * n
        out[key] = v.astype(np.float32)
    return out


def _load(model: torch.nn.Module, w: dict) -> None:
    model.load_state_dict({k: torch.as_tensor(v) for k, v in w.items()}, strict=True)


def _ring_points(rng, scans: int, p: int, r=(2.0, 45.0)):
    """[scans, p, 3] points on a ring around the sensor and [scans, p, 3]
    point features."""
    rad = rng.uniform(*r, (scans, p))
    th = rng.uniform(-np.pi, np.pi, (scans, p))
    xyz = np.stack([rad * np.cos(th), rad * np.sin(th), rng.uniform(-3.5, 1.5, (scans, p))],
                   -1).astype(np.float32)
    return xyz, rng.uniform(0, 1, (scans, p, 3)).astype(np.float32)


def _mh_inputs():
    rng = np.random.default_rng(11)
    xyz, feats = _ring_points(rng, 2, 900)
    bidx = np.repeat(np.arange(2, dtype=np.int32), 900)
    valid = rng.random(1800) < 0.95
    return xyz.reshape(-1, 3), feats.reshape(-1, 3), bidx, valid


def _rc_inputs():
    """A UNet plan's input: two synthetic scans quantized at 0.05 m."""
    rng = np.random.default_rng(12)
    xyz, _ = _ring_points(rng, 2, 900, r=(2.0, 8.0))
    coords = np.zeros((RC_CAP0, 4), np.int32)
    valid = np.zeros(RC_CAP0, bool)
    off = 0
    for b in range(2):
        q = np.unique(np.floor(xyz[b] / 0.05).astype(np.int32), axis=0)
        coords[off:off + len(q), 0] = b
        coords[off:off + len(q), 1:] = q
        valid[off:off + len(q)] = True
        off += len(q)
    feats = rng.uniform(0, 1, (RC_CAP0, 1)).astype(np.float32) * valid[:, None]
    return coords, valid, feats


def _cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _train_cfg_kw():
    return dict(num_labeled_classes=14, num_classes=16, unknown_label=14,
                num_unlabeled_classes=2, grid_shape=GRID, caps=PLAN_CAPS, base_channels=8,
                point_cap=900, num_scans=2, use_scheduler=False)


def _train_points():
    rng = np.random.default_rng(13)
    xyz, feats = _ring_points(rng, 2, 900)
    return {"xyz": xyz, "feats": feats,
            "labels": rng.integers(0, 15, (2, 900)).astype(np.int32),
            "mapped_labels": rng.integers(0, 15, (2, 900)).astype(np.int32),
            "valid": rng.random((2, 900)) < 0.95}


def _s2_setup(root: Path):
    """The Stage-2 config (Cylinder3D) and its batches, from the JAX
    package's datasets (numpy)."""
    write_synthetic_kitti(str(root), sequences=("00",), scans_per_seq=4, num_points=900, seed=2)
    meta = dataset_meta("SemanticKITTI")
    unknown, _ = split_table("SemanticKITTI", 1)
    mapping, _, unk = build_label_mapping(unknown, meta["learning_map_inv"].keys())
    kw = dict(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
              unknown_label=unk, voxel_caps=S2_CAPS, sup_voxel_cap=S2_SUP_CAP,
              mix_voxel_caps=S2_CAPS, num_sup_scans=2, point_cap=700, voxel_size=0.15,
              arch="Cylinder3D", feat_dim=128, cand_cap=256, queue_slots=4, queue_per_slot=64,
              kmeans_iters=5, use_scheduler=False)
    dskw = dict(voxel_size=0.15, label_mapping=mapping, unknown_labels=unknown,
                downsampling=800, augment=True)
    lab = SemanticKITTIDataset(str(root), "train", split_indices=np.array([0, 1]), labeled=True,
                               resize_aug=True, seed=0, **dskw)
    unlab = SemanticKITTIDataset(str(root), "train", split_indices=np.array([0, 1]),
                                 labeled=False, seed=1, **dskw)
    sup = collate_batch([lab[0], lab[1]], S2_SUP_CAP, point_cap=700)
    unsup = collate_batch([unlab[0], unlab[1]], S2_CAPS[0] - S2_SUP_CAP, point_cap=700)
    return kw, sup, unsup


S2_LOSS_KEYS = ("loss", "sup_seg", "mse", "lasermix", "calib", "thr_loss", "novel_unsup",
                "novel_sup", "ncc_unsup", "tau")
S2_COUNT_KEYS = ("n_cand", "n_rel", "has_novel", "plan_overflow", "cand_overflow")


def _jax_goldens(tmp: Path) -> dict:
    """Every golden of tests 3 and 4, computed by the JAX package."""
    g = {}

    def put_tree(prefix, sd):
        for k, v in sd.items():
            g[f"{prefix}/{k}"] = _summary(v)

    def model_goldens(prefix, apply, w, args, keys, seed):
        """Training-mode outputs and statistics; eval-mode loss and gradients
        (training-mode batch norm over these few voxels makes the gradients
        ill-conditioned: 1e-6 relative noise on the weights moves some by
        30%, on either package alone)."""
        params, stats = cylinder_state_dict_to_jax(w)

        def fwd(p, s, *a):
            return apply({"params": p, "batch_stats": s}, *a, train=True,
                         mutable=["batch_stats"])

        def loss_fn(p, s, *a):
            out = apply({"params": p, "batch_stats": s}, *a, train=False)
            return sum(jnp.sum(out[k] * _cotangent(out[k].shape, seed + i))
                       for i, k in enumerate(keys))

        out, mut = jax.jit(fwd)(params, stats, *args)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, stats, *args)
        g[f"{prefix}/loss"] = np.float64(loss)
        for k in keys:
            g[f"{prefix}/{k}"] = _summary(out[k])
        put_tree(f"{prefix}/grad", cylinder_jax_to_state_dict(grads, {}))
        put_tree(f"{prefix}/stats", {k: v for k, v in cylinder_jax_to_state_dict(
            params, mut["batch_stats"]).items() if k.endswith(("running_mean", "running_var"))})
        return params, stats, out

    # 3a. MultiHeadCylinder3D
    w = _weights(tcyl.MultiHeadCylinder3D(**MH_KW).state_dict(), 1)
    inputs = [jnp.asarray(a) for a in _mh_inputs()]
    params, stats, out = model_goldens("mh", jcyl.MultiHeadCylinder3D(**MH_KW).apply, w, inputs,
                                       MH_KEYS, 21)
    for k in ("voxel_valid", "point_inverse"):
        g[f"mh/{k}"] = _digest(out[k])
    # the cylinder plan of this forward: the VFE's voxels, then the books
    vfe = jcyl.SegVFE(grid_shape=GRID)
    vox = jax.jit(lambda p, s, *a: vfe.apply({"params": p, "batch_stats": s}, *a,
                                             PLAN_CAPS[0], False))(
        params["encoder"], stats["encoder"], *inputs)
    plan = jax.jit(jcyl.build_cyl_plan, static_argnums=2)(vox["coords"], vox["valid"],
                                                          PLAN_CAPS)
    for i, lvl in enumerate(plan.levels):
        for k in ("coords", "valid", "nbr27"):
            g[f"plan/L{i}/{k}"] = _digest(getattr(lvl, k))
    for i, e in enumerate(plan.edges):
        g[f"plan/E{i}/down"], g[f"plan/E{i}/up"] = _digest(e.down_map), _digest(e.up_map)

    # 3b. Cylinder3DRC on a UNet plan
    w = _weights(tcyl.Cylinder3DRC(17, 2, base_channels=8).state_dict(), 2)
    jr = jcyl.Cylinder3DRC(num_labeled=17, num_novel=2, base_channels=8)

    def rc_apply(variables, coords, cvalid, cfeats, **kw):
        return jr.apply(variables, jax_build_unet_plan(coords, cvalid, RC_CAPS), cfeats, **kw)

    model_goldens("rc", rc_apply, w, [jnp.asarray(a) for a in _rc_inputs()], RC_KEYS, 30)

    # 4a. the supervised trainer: two steps and the eval confusion
    cfg = jtc.CylinderConfig(**_train_cfg_kw())
    w = _weights(ttc.make_model(ttc.CylinderConfig(**_train_cfg_kw())).state_dict(), 3)
    params, stats = cylinder_state_dict_to_jax(w)
    tx = jcommon.make_sgd(cfg, lambda step: cfg.lr)
    state = jcommon.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                               step=jnp.zeros((), jnp.int32))
    pts = {k: jnp.asarray(v) for k, v in _train_points().items()}
    lut = jnp.asarray(jcommon.inv_label_lut({i: i + 1 for i in range(14)}, 14))
    g["tr/conf0"] = np.asarray(jtc.cylinder_eval_step(state, pts, lut, cfg))
    for i in range(2):
        state, m = jtc.cylinder_train_step(state, pts, cfg)
        for k in ("loss", "ce", "lovasz"):
            g[f"tr/step{i}/{k}"] = np.float64(m[k])
    put_tree("tr/state", cylinder_jax_to_state_dict(state.params, state.batch_stats))
    g["tr/conf"] = np.asarray(jtc.cylinder_eval_step(state, pts, lut, cfg))

    # 4b. one Stage-2 step on Cylinder3D with the JAX draws
    kw, sup, unsup = _s2_setup(tmp)
    jcfg = jd.DiscoverConfig(**kw)
    w = _weights(td.make_model(td.DiscoverConfig(**kw)).state_dict(), 4)
    params, stats = cylinder_state_dict_to_jax(w)
    tau = jnp.asarray(jcfg.tau_init, jnp.float32)
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731
    jstate = jd.DiscoverState(
        params_s=copy(params), batch_stats_s=copy(stats), params_t=copy(params),
        batch_stats_t=copy(stats), tau=tau,
        opt_state=jd.make_optimizer(jcfg).init({"model": params, "tau": tau}),
        queue=jq.queue_init(jcfg.queue_slots, jcfg.queue_per_slot, jcfg.feat_dim),
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(2))  # its k-means keeps 144
    _, k_kmeans, k_areas, _ = jax.random.split(jstate.rng, 4)
    g["s2/num_areas"] = np.asarray(jax.random.choice(k_areas, jnp.asarray([3, 4, 5, 6],
                                                                          jnp.int32)))
    n = min(jcfg.cand_cap, jcfg.voxel_caps[0]) + jcfg.queue_slots * jcfg.queue_per_slot
    g["s2/kmeans_scores"] = np.asarray(jax.random.uniform(k_kmeans, (n,)))
    jb = [jcommon.voxel_batch_to_device(sup["voxel"]),
          jcommon.point_batch_to_device(sup["points"]),
          jcommon.voxel_batch_to_device(unsup["voxel"]),
          jcommon.point_batch_to_device(unsup["points"])]
    jstate, m = jd.discover_train_step(jstate, *jb, jcfg)
    for k in S2_LOSS_KEYS + S2_COUNT_KEYS:
        g[f"s2/{k}"] = np.asarray(m[k])
    put_tree("s2/student", cylinder_jax_to_state_dict(jstate.params_s, jstate.batch_stats_s))
    put_tree("s2/teacher", cylinder_jax_to_state_dict(jstate.params_t, jstate.batch_stats_t))
    g["s2/queue_feats"] = _summary(jstate.queue[0])
    g["s2/queue_counts"] = np.asarray(jstate.queue[1])
    g["s2/queue_head"] = np.asarray(jstate.queue[2])
    return g


def _pack(g: dict) -> dict:
    """The goldens as three arrays: digests, numbers (float64, which holds
    the f32 summaries and the int32 counts exactly) and their layout."""
    digests = sorted(k for k, v in g.items() if isinstance(v, str))
    nums = sorted(k for k in g if k not in digests)
    arrs = [np.asarray(g[k]) for k in nums]
    return {"digest_keys": np.array(digests), "digests": np.array([g[k] for k in digests]),
            "layout": np.array(json.dumps([(k, a.shape, a.dtype.str) for k, a in zip(nums, arrs)])),
            "data": np.concatenate([a.astype(np.float64).ravel() for a in arrs])}


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDENS) as f:
        g = dict(zip(f["digest_keys"].tolist(), f["digests"].tolist()))
        data, off = f["data"], 0
        for k, shape, dtype in json.loads(str(f["layout"])):
            n = int(np.prod(shape))
            g[k] = data[off:off + n].reshape(shape).astype(dtype)
            off += n
    return g


def _golden_tree(g: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in g.items() if k.startswith(prefix + "/")}


# ------------------------------------------------------------- 1. books, convs


def _fine_level(seed: int, n: int, cap: int):
    """A sorted unique level of random coords in [0, 24)^3, two batches, with
    voxels at coordinate 0 on each axis; JAX keys and coords."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((n, 4), np.int32)
    coords[:, 0] = rng.integers(0, 2, n)
    coords[:, 1:] = rng.integers(0, 24, (n, 3))
    coords[:3, 1:] = [[0, 5, 7], [3, 0, 9], [4, 6, 0]]
    valid = rng.random(n) < 0.9
    hi, lo = jc.encode_coords(jnp.asarray(coords), jnp.asarray(valid))
    (uh, ul), _, _, _ = jc.sorted_unique(hi, lo, cap)
    fvalid = uh != jc.SENTINEL_HI
    fcoords = jnp.where(fvalid[:, None], jc.decode_keys(uh, ul), 0)
    return coords, valid, fcoords, fvalid, (uh, ul)


def test_asym_books_and_paired_conv_match_jax():
    """Subsets, pooled levels, down and up books and the cylinder plan bit
    for bit; the strided convs (both role orders, both strides) and every
    asymmetric subset's submanifold conv with their gradients."""
    for shape in tcyl.KERNEL_SHAPES:
        _eq(ta.offset_subset(shape), ja.offset_subset(shape), shape)
    _, _, fcoords, fvalid, keys = _fine_level(0, 3000, 2048)
    tkeys = (_t(keys[0]), _t(keys[1]))
    rng = np.random.default_rng(1)
    for stride in STRIDES:
        jn = ja.pool_coords(fcoords, fvalid, stride, 1536)
        tn = ta.pool_coords(_t(fcoords), _t(fvalid), stride, 1536)
        for k in ("coords", "valid", "count", "parent"):
            _eq(tn[k], jn[k], (stride, k))
        for a, b in zip(tn["keys"], jn["keys"]):
            _eq(a, b, stride)
        jdown = ja.strided_down_map(jn["coords"], jn["valid"], keys, stride)
        jup = ja.inverse_up_map(fcoords, fvalid, jn["keys"], stride)
        tdown = ta.strided_down_map(tn["coords"], tn["valid"], tkeys, stride)
        tup = ta.inverse_up_map(_t(fcoords), _t(fvalid), tn["keys"], stride)
        _eq(tdown, jdown, (stride, "down"))
        _eq(tup, jup, (stride, "up"))
        xs = rng.standard_normal((fcoords.shape[0], 4)).astype(np.float32)
        ws = rng.standard_normal((27, 4, 6)).astype(np.float32)
        _close(ta.strided_gather_conv(_t(xs), tdown, _t(ws)),
               ja.strided_gather_conv(jnp.asarray(xs), jdown, jnp.asarray(ws)), OP_TOL, stride)
        assert int((tup[:3] >= 0).sum()) > 0  # the coordinate-0 rows find parents
        nf, nc = fcoords.shape[0], jn["coords"].shape[0]
        for order, (fwd, adj, n_in) in enumerate(((jdown, jup, nf), (jup, jdown, nc))):
            ci, co = 12, 20
            x = (rng.standard_normal((n_in, ci)) * rng.random((n_in, 1))).astype(np.float32)
            w = (rng.standard_normal((27, ci, co)) / 9).astype(np.float32)
            out, vjp = jax.vjp(lambda x, w: jconv.paired_gather_conv(x, fwd, adj, w),
                               jnp.asarray(x), jnp.asarray(w))
            gout = rng.standard_normal(out.shape).astype(np.float32)
            jdx, jdw = vjp(jnp.asarray(gout))
            tfwd, tadj = _t(fwd), _t(adj)
            for name, fn in (("plain", tconv.paired_gather_conv), ("pool_conv", pool_conv)):
                xt = _t(x).requires_grad_()
                wt = _t(w).requires_grad_()
                ot = fn(xt, tfwd, tadj, wt)
                ot.backward(_t(gout))
                what = (stride, ("down", "up")[order], name)
                _close(ot, out, OP_TOL, what)
                _close(xt.grad, jdx, OP_TOL, what)
                _close(wt.grad, jdw, OP_TOL, what)

    # the cylinder plan: levels, maps and the paired books of each edge
    coords, valid, _, _, _ = _fine_level(2, 2600, 2048)
    jplan = jax.jit(jcyl.build_cyl_plan, static_argnums=2)(jnp.asarray(coords),
                                                           jnp.asarray(valid), PLAN_CAPS)
    tplan = tcyl.build_cyl_plan(_t(coords), _t(valid), PLAN_CAPS)
    for i, (tl, jl) in enumerate(zip(tplan.levels, jplan.levels)):
        for k in ("coords", "valid", "nbr27"):
            _eq(getattr(tl, k), getattr(jl, k), (i, k))
        for shape in tcyl.KERNEL_SHAPES:
            book = tl.books[shape]
            assert book.is_contiguous()
            _eq(book, np.asarray(jl.nbr27)[:, ja.offset_subset(shape)], (i, shape))
    for i, (te, je) in enumerate(zip(tplan.edges, jplan.edges)):
        _eq(te.down_map, je.down_map, (i, "down"))
        _eq(te.up_map, je.up_map, (i, "up"))
    assert [int(lv.valid.sum()) for lv in tplan.levels][-1] > 0

    # each subset's submanifold conv (the reversed book is its adjoint)
    lvl, jl = tplan.levels[0], jplan.levels[0]
    n = lvl.valid.shape[0]
    for shape in tcyl.KERNEL_SHAPES:
        cols = ja.offset_subset(shape)
        x = (rng.standard_normal((n, 8)) * _np(lvl.valid)[:, None]).astype(np.float32)
        w = (rng.standard_normal((len(cols), 8, 16)) / 4).astype(np.float32)
        nbr = jl.nbr27[:, cols]
        out, vjp = jax.vjp(lambda x, w: jconv.gather_conv(x, nbr, w, symmetric_adjoint=True),
                           jnp.asarray(x), jnp.asarray(w))
        gout = rng.standard_normal(out.shape).astype(np.float32)
        jdx, jdw = vjp(jnp.asarray(gout))
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        ot = subm_conv(xt, lvl.books[shape], wt)
        ot.backward(_t(gout))
        _close(ot, out, OP_TOL, shape)
        _close(xt.grad, jdx, OP_TOL, shape)
        _close(wt.grad, jdw, OP_TOL, shape)

    # the head's logit conv (with its bias) and its CE + 3 x Lovasz loss
    x = (rng.standard_normal((n, 8)) * _np(lvl.valid)[:, None]).astype(np.float32)
    head = tcyl.Cylinder3DHead(8, 5)
    w = {"kernel": (rng.standard_normal((27, 8, 5)) / 8).astype(np.float32),
         "bias": rng.standard_normal(5).astype(np.float32)}
    _load(head, w)
    jlogits = jcyl.Cylinder3DHead(num_classes=5).apply({"params": w}, jnp.asarray(x), jl.nbr27,
                                                       jl.valid)
    with torch.no_grad():
        tlogits = head(_t(x), lvl)
    _close(tlogits, jlogits, OP_TOL, "head")
    labels = np.where(_np(lvl.valid), rng.integers(-1, 5, n), -1).astype(np.int32)
    jloss, jparts = jcyl.Cylinder3DHead.loss(jlogits, jnp.asarray(labels), jl.valid)
    tloss, tparts = tcyl.Cylinder3DHead.loss(tlogits, _t(labels), lvl.valid)
    for k in ("ce", "lovasz"):
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


# ------------------------------------------------------ 2. scatter, lovasz, voxelizer


def test_scatter_lovasz_voxelizer_match_jax():
    rng = np.random.default_rng(3)
    # cylindrical coordinates and the VFE's bins on 20,000 points
    xyz, _ = _ring_points(rng, 1, 20000, r=(0.5, 60.0))
    xyz = xyz[0]
    jcyl_c = np.asarray(jsc.cylindrical_coords(jnp.asarray(xyz)))
    tcyl_c = tsc.cylindrical_coords(_t(xyz))
    _close(tcyl_c, jcyl_c, 1e-7, "cylindrical")
    vfe = tcyl.SegVFE(1)
    jvfe = jcyl.SegVFE()
    lo = np.asarray(jvfe.point_cloud_range[:3])
    jbins = np.asarray(jnp.floor((jnp.asarray(jcyl_c) - lo) / jvfe.voxel_size()).astype(
        jnp.int32))
    tbins = torch.floor((tcyl_c - vfe.lo) / vfe.vs).to(torch.int32)
    moved = int((_np(tbins) != jbins).any(axis=1).sum())
    assert moved == 0, f"{moved} of 20000 points change bin"

    # dynamic voxelize and the max / mean scatter, with tied maxima
    n = 600
    pts = rng.uniform(-1.0, 4.0, (n, 3)).astype(np.float32)
    bidx = rng.integers(0, 2, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    feats = rng.integers(-3, 4, (n, 5)).astype(np.float32)  # small integers: many ties
    pcr, vs = (0.0, 0.0, 0.0, 3.0, 3.0, 3.0), (0.5, 0.5, 0.75)
    jco, jin = jsc.dynamic_voxelize(jnp.asarray(pts), jnp.asarray(bidx), jnp.asarray(valid),
                                    pcr, vs)
    tco, tin = tsc.dynamic_voxelize(_t(pts), _t(bidx), _t(valid), pcr, vs)
    _eq(tco, jco)
    _eq(tin, jin)
    for mode in ("max", "mean"):
        for cap in (64, 16):  # 16 drops voxels
            jout, vjp = jax.vjp(lambda f: jsc.dynamic_scatter(f, jco, jin, cap, mode)["feats"],
                                jnp.asarray(feats))
            full = jsc.dynamic_scatter(jnp.asarray(feats), jco, jin, cap, mode)
            g = rng.standard_normal(jout.shape).astype(np.float32)
            (jgrad,) = vjp(jnp.asarray(g))
            ft = _t(feats).requires_grad_()
            tout = tsc.dynamic_scatter(ft, tco, tin, cap, mode)
            tout["feats"].backward(_t(g))
            for k in ("coords", "valid", "count", "inverse", "rep"):
                _eq(tout[k], full[k], (mode, cap, k))
            _close(tout["feats"], jout, OP_TOL, (mode, cap))
            _close(ft.grad, jgrad, OP_TOL, (mode, cap, "grad"))
    # hard voxelization: per-voxel buffers, first points kept
    for cap, mp in ((64, 3), (8, 2)):
        jh = jsc.hard_voxelize(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(bidx),
                               jnp.asarray(valid), pcr, vs, cap, mp)
        th = tsc.hard_voxelize(_t(pts), _t(feats), _t(bidx), _t(valid), pcr, vs, cap, mp)
        for k in jh:
            _eq(th[k], jh[k], (cap, k))
    idx = rng.integers(-3, 12, n).astype(np.int32)  # negative and out-of-range ids
    _close(tsc.scatter_mean(_t(feats), _t(idx), 10),
           jsc.scatter_mean(jnp.asarray(feats), jnp.asarray(idx), 10), OP_TOL, "scatter_mean")

    # Lovasz-Softmax: value and gradient; rows at equal errors and masked rows
    c = 6
    logits = rng.standard_normal((400, c)).astype(np.float32)
    logits[:50] = 0.0  # equal probabilities: tied errors
    labels = rng.integers(-1, c, 400).astype(np.int32)
    labels[labels == 4] = 5  # class 4 absent
    lvalid = rng.random(400) < 0.9
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    for classes in ("present", "all"):
        jv, jg = jax.value_and_grad(lambda p: jlv.lovasz_softmax(
            p, jnp.asarray(labels), jnp.asarray(lvalid), classes))(jnp.asarray(probs))
        pt = _t(probs).requires_grad_()
        tv = tlv.lovasz_softmax(pt, _t(labels), _t(lvalid), classes)
        tv.backward()
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6, err_msg=classes)
        _close(pt.grad, jg, OP_TOL, classes)
    assert float(tlv.lovasz_softmax(torch.nn.functional.one_hot(
        _t(labels).clamp(min=0).long(), c).float(), _t(labels))) < 1e-6

    # the voxelizer front end in its four modes
    for mode, kw in (("hard", dict(voxel_size=vs, point_cloud_range=pcr, max_voxels=64,
                                   max_num_points=3)),
                     ("dynamic", dict(voxel_size=vs, point_cloud_range=pcr)),
                     ("cylindrical", dict(voxel_size=(0.5, 0.3, 0.5),
                                          point_cloud_range=(0.0, -np.pi, -1.0, 6.0, np.pi, 4.0),
                                          max_voxels=128)),
                     ("minkunet", dict(voxel_size=(0.4, 0.4, 0.4), max_voxels=256))):
        jo = jvox.Voxelizer(mode, **kw).voxelize(jnp.asarray(pts), jnp.asarray(feats),
                                                 jnp.asarray(bidx), jnp.asarray(valid))
        to = tvox.Voxelizer(mode, **kw).voxelize(_t(pts), _t(feats), _t(bidx), _t(valid))
        assert set(to) == set(jo), mode
        for k, v in jo.items():
            if k == "keys":
                for a, b in zip(to[k], v):
                    _eq(a, b, (mode, k))
            elif np.issubdtype(np.asarray(v).dtype, np.floating):
                _close(to[k], v, OP_TOL, (mode, k))
            else:
                _eq(to[k], v, (mode, k))


# ------------------------------------------------------- 3. models vs goldens


def _run_model(model, w: dict, args: tuple, keys: tuple, seed: int):
    """As `_jax_goldens`' `model_goldens`: eval-mode loss and gradients, then
    the training-mode outputs, which move the batch-norm statistics."""
    _load(model, w)
    model.eval()
    out = model(*args)
    loss = sum((out[k] * _t(_cotangent(out[k].shape, seed + i))).sum()
               for i, k in enumerate(keys))
    loss.backward()
    model.train()
    with torch.no_grad():
        return model(*args), loss.detach()


def _check_model(g: dict, prefix: str, model, out: dict, loss, keys) -> None:
    np.testing.assert_allclose(float(loss), float(g[f"{prefix}/loss"]), rtol=MODEL_TOL)
    for k in keys:
        _match(out[k], g[f"{prefix}/{k}"], MODEL_TOL, f"{prefix} {k}")
    grads = _golden_tree(g, f"{prefix}/grad")
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for k, ref in grads.items():
        _match(params[k].grad, ref, MODEL_TOL, f"{prefix} grad {k}")
    sd = model.state_dict()
    stats = _golden_tree(g, f"{prefix}/stats")
    assert len(stats) == 2 * sum(isinstance(m, SparseBatchNorm) for m in model.modules())
    for k, ref in stats.items():
        _match(sd[k], ref, MODEL_TOL, f"{prefix} stats {k}")


def test_cylinder_models_match_jax_goldens(goldens):
    """MultiHeadCylinder3D and Cylinder3DRC against the JAX package, weights
    carried across: the cylinder plan of the forward bit for bit, the
    training-mode outputs and batch-norm statistics, the eval-mode loss and
    every gradient."""
    g = goldens
    model = tcyl.MultiHeadCylinder3D(**MH_KW)
    mh_in = tuple(_t(a) for a in _mh_inputs())
    out, loss = _run_model(model, _weights(model.state_dict(), 1), mh_in, MH_KEYS, 21)
    with torch.no_grad():  # the plan of the forward, from the VFE's voxels (eval mode:
        vox = model.encoder.eval()(*mh_in, PLAN_CAPS[0])  # no statistic moves)
        plan = tcyl.build_cyl_plan(vox["coords"], vox["valid"], PLAN_CAPS)
    for i, lvl in enumerate(plan.levels):
        for k in ("coords", "valid", "nbr27"):
            assert _digest(getattr(lvl, k)) == g[f"plan/L{i}/{k}"], (i, k)
    for i, e in enumerate(plan.edges):
        assert _digest(e.down_map) == g[f"plan/E{i}/down"], i
        assert _digest(e.up_map) == g[f"plan/E{i}/up"], i
    assert _digest(out["voxel_valid"]) == g["mh/voxel_valid"]
    assert _digest(out["point_inverse"]) == g["mh/point_inverse"]
    assert out["logits_unlab_over"].shape == (2, PLAN_CAPS[0], 6)
    _check_model(g, "mh", model, out, loss, MH_KEYS)

    model = tcyl.Cylinder3DRC(17, 2, base_channels=8)
    coords, valid, feats = _rc_inputs()
    rc_in = (build_unet_plan(_t(coords), _t(valid), RC_CAPS), _t(feats))
    out, loss = _run_model(model, _weights(model.state_dict(), 2), rc_in, RC_KEYS, 30)
    assert out["feats"].shape == (RC_CAP0, 32)
    _check_model(g, "rc", model, out, loss, RC_KEYS)


# -------------------------------------------------------- 4. steps vs goldens


def test_cylinder_steps_match_jax_goldens(goldens, tmp_path):
    """Two supervised steps and the eval confusion; one Stage-2 step on
    Cylinder3D with the JAX draws. The entry point refuses to run without a
    card unless asked for the CPU."""
    g = goldens
    cfg = ttc.CylinderConfig(**_train_cfg_kw())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttc.create_cylinder_state(0, cfg)
    state = ttc.create_cylinder_state(0, cfg, device="cpu")
    _load(state.model, _weights(state.model.state_dict(), 3))
    pts = {k: _t(v) for k, v in _train_points().items()}
    lut = _t(jcommon.inv_label_lut({i: i + 1 for i in range(14)}, 14))
    conf0 = ttc.cylinder_eval_step(state, pts, lut, cfg)
    assert int(conf0.sum()) > 0
    _eq(conf0, g["tr/conf0"])
    for i in range(2):
        state, m = ttc.cylinder_train_step(state, pts, cfg)
        for k in ("loss", "ce", "lovasz"):
            np.testing.assert_allclose(float(m[k]), float(g[f"tr/step{i}/{k}"]),
                                       rtol=MODEL_TOL, err_msg=(i, k))
    sd = state.model.state_dict()
    ref = _golden_tree(g, "tr/state")
    assert set(ref) == set(sd)
    for k, v in ref.items():
        _match(sd[k], v, STEP_TOL, f"tr {k}")
    # after the steps, the parameters' drift (STEP_TOL) may move a point at an
    # argmax tie: at most 2 of the 1,710 points change class (measured: 1)
    conf = ttc.cylinder_eval_step(state, pts, lut, cfg).numpy()
    assert conf.sum() == g["tr/conf"].sum() > 0
    assert np.abs(conf - g["tr/conf"]).sum() <= 4

    kw, sup, unsup = _s2_setup(tmp_path / "kitti")
    tcfg = td.DiscoverConfig(**kw)
    tstate = td.create_discover_state(0, tcfg, device="cpu")
    assert isinstance(tstate.student, tcyl.Cylinder3DRC)
    params, stats = cylinder_state_dict_to_jax(_weights(tstate.student.state_dict(), 4))
    load_jax_discover_state(tstate, dict(
        params_s=params, batch_stats_s=stats, params_t=params, batch_stats_t=stats,
        tau=np.float32(tcfg.tau_init), step=0,
        queue=tuple(np.asarray(a) for a in jq.queue_init(tcfg.queue_slots, tcfg.queue_per_slot,
                                                          tcfg.feat_dim))))
    draws = {"num_areas": _t(g["s2/num_areas"]), "kmeans_scores": _t(g["s2/kmeans_scores"])}
    tstate, m = td.discover_train_step(
        tstate, tcommon.voxel_batch_to_device(sup["voxel"], "cpu"),
        tcommon.voxel_batch_to_device(unsup["voxel"], "cpu"), tcfg, draws=draws)
    for k in S2_LOSS_KEYS:
        np.testing.assert_allclose(float(m[k]), float(g[f"s2/{k}"]), rtol=MODEL_TOL,
                                   atol=1e-6, err_msg=k)
    for k in S2_COUNT_KEYS:
        assert int(m[k]) == int(g[f"s2/{k}"]), k
    assert int(m["n_cand"]) > 0
    for who, model in (("student", tstate.student), ("teacher", tstate.teacher)):
        sd = model.state_dict()
        ref = _golden_tree(g, f"s2/{who}")
        assert set(ref) == set(sd)
        for k, v in ref.items():
            _match(sd[k], v, STEP_TOL, f"s2 {who} {k}")
    _match(tstate.queue[0], g["s2/queue_feats"], MODEL_TOL, "queue feats")
    _eq(tstate.queue[1], g["s2/queue_counts"])
    _eq(tstate.queue[2], g["s2/queue_head"])


@pytest.mark.slow
def test_cylinder_goldens_are_the_jax_package(goldens, tmp_path):
    """The frozen goldens, rebuilt from the JAX package (minutes of XLA
    compile on the CPU)."""
    fresh = _jax_goldens(tmp_path)
    assert set(fresh) == set(goldens)
    for k, v in fresh.items():
        ref = goldens[k]
        if isinstance(ref, str):
            assert ref == v, k
        elif ref.dtype.kind == "f":
            np.testing.assert_allclose(v, ref, rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            _eq(v, ref, k)


if __name__ == "__main__":
    # python tests/test_torch_cylinder.py <scratch dir>: write the goldens
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDENS, **_pack(_jax_goldens(Path(sys.argv[1]))))
