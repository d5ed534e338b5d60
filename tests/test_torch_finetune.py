"""PyTorch port vs JAX package: Stage 1.5 (NCC fine-tuning) on the CPU.

Blocks, eagerly: `soft_cross_entropy`, `NormedLinear`, the four
`feature_mixing` functions, `_centroid_mix`, `_mixed_logits` (both heads, with
the gradients it sends to the raw head weights), `_entropy_terms` (each term
alone), `_mix_ratio`, `_threshold` (4 schedules over 8 epochs) and the
pseudo-label rules. Steps, one compiled JAX step per variant, at MinkUNet14
with caps (2048, 1024, 512, 512, 256): `finetune_train_step` for mix modes
none (2 steps), pairs on cosine heads (2) and centroid with the linear
schedule (1); `finetune_extra_train_step` for ExpMixExtraFineTuning (2),
ExpRCExtra (1) and ExpClusterFineTuning (1; the JAX step with its miner
handed the plan rows' coordinates, `_jax_cluster_twin`: the JAX package
hands it the input rows', `test_torch_cluster.py` shows the misalignment).
The JAX initial state is carried into the port (`utils.weights`) and the
permutations the JAX step draws from `fold_in(PRNGKey(1234 or 4321), step)`
are fed to the port's step. Then the uncertainty ranking, the threshold
sweep (plain, and subdivided on both of its routes), the registry, the
Stage-1 -> 1.5 warm start and the recipes that used to be refused. The port runs its plain kernel versions here.
At these caps the plans drop voxels from L1 on; both sides drop the same
ones (plan parity at overflow: `test_torch_plan.py`). Where the JAX package
builds a state only to be read (the ranking, the sweep, the warm start's
Stage-1 model), its trees are laid out by `jax.eval_shape` and filled with
the port's tensors, which costs no compile.

Tolerances: f32 on both sides, so floats differ by summation order only
(`test_steps_are_well_conditioned` checks that the steps do not amplify it
from the fixture's initial state):
losses rtol 1e-5 (atol 1e-6 where a term is 0 up to rounding); parameters and
batch-norm statistics 1e-4 of each tensor's largest magnitude (as in
test_torch_slice.py); the heads' updates 1e-3 of the update's largest
magnitude; sweep mIoUs 1e-6. Masks, permutations, pseudo labels and the
uncertainty order are exact.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from gcdlss_tpu import losses as jl
from gcdlss_tpu.data import (SemanticKITTIDataset, build_label_mapping, collate_batch,
                             dataset_meta, split_table, write_synthetic_kitti)
from gcdlss_tpu.eval import sweep as jsweep
from gcdlss_tpu.models import layers as jlayers
from gcdlss_tpu.ops.plan import build_unet_plan as jbuild_unet_plan
from gcdlss_tpu.train import common as jcommon
from gcdlss_tpu.train import feature_mixing as jfm
from gcdlss_tpu.train import finetune as jft
from gcdlss_tpu.train import nops as jnops
from gcdlss_tpu.train import pretrain as jpt
from gcdlss_tpu.train import registry as jreg
from gcdlss_tpu.train import schedule as jschedule
from gcdlss_tpu.train import uncertainty as junc
from gcdlss_tpu_torch import losses as tl
from gcdlss_tpu_torch.data import SemanticKITTIDataset as TorchSemanticKITTIDataset
from gcdlss_tpu_torch.eval import sweep as tsweep
from gcdlss_tpu_torch.models import layers as tlayers
from gcdlss_tpu_torch.train import common as tcommon
from gcdlss_tpu_torch.train import feature_mixing as tfm
from gcdlss_tpu_torch.train.discover import _combine_batches
from gcdlss_tpu_torch.train import finetune as tft
from gcdlss_tpu_torch.train import pretrain as tpt
from gcdlss_tpu_torch.train import registry as treg
from gcdlss_tpu_torch.train import uncertainty as tunc
from gcdlss_tpu_torch.utils.weights import (jax_to_state_dict, load_jax_params,
                                            load_reference_state_dict)

CAPS = (2048, 1024, 512, 512, 256)
SUP_CAP = 1024
PLANES = (16, 16, 32, 32, 32, 16, 16, 16)
LABEL_SPACE = dict(num_labeled_classes=17, num_classes=19, unknown_label=17)
# step-level variants: (registry name, steps, Extra step?)
VARIANTS = {
    "none": ("ExpFineTuning", 2, False),
    "pairs_cosine": ("ExpMixCosineFineTuning", 2, False),
    "centroid_linear": ("ExpBetaSchedulingFineTuning", 1, False),
    "mix_extra": ("ExpMixExtraFineTuning", 2, True),
    "rc_extra": ("ExpRCExtra", 1, True),
    "cluster_extra": ("ExpClusterFineTuning", 1, True),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one CPU thread while this module's tests run:
    the suite runs several workers at once, and each worker's default pool
    of one thread a core, spinning in turn, multiplied the port's CPU time
    many times over. The pool's size is restored when the module's tests
    end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, ref, scale_tol, what=""):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=scale_tol * max(float(np.abs(ref).max(initial=0)), 1e-6),
                               err_msg=what)


def _eq(got, ref, what=""):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref), err_msg=what)


def _cfgs(name, **kw):
    """(port, JAX) FineTuneConfig of registry recipe `name` at the test size."""
    fields = dict(arch="MinkUNet14", planes=PLANES, lr=0.05, use_scheduler=False,
                  steps_per_epoch=2, epochs=3, **LABEL_SPACE)
    _, tcfg = treg.finetune_config(name, voxel_caps=CAPS, batch_size=4, **{**fields, **kw})
    return tcfg, jft.FineTuneConfig(**dataclasses.asdict(tcfg))


def _spread_ncc(model):
    """Scale the port model's `final` and `final2` in place so that the
    fixture's dummy probabilities spread: at random init every row's NCC
    probability sits at ~1/18, under every threshold, and no known class wins
    a row."""
    heads = model.encoder
    with torch.no_grad():
        heads.final.kernel.mul_(40.0)
        heads.final2.kernel.mul_(40.0)
        heads.final2.bias.add_(2.0)


def _jax_trees(jmodel, model):
    """The JAX (params, batch_stats) trees of `jmodel` holding the port
    `model`'s tensors. The trees' layout comes from `jax.eval_shape` of the
    JAX init (a trace; the JAX package's state constructors compile a
    program each), every leaf from the port key `jax_to_state_dict` maps it
    to, with its shape checked."""
    def init():
        n = 256
        coords = jnp.zeros((n, 4), jnp.int32).at[:, 1].set(jnp.arange(n, dtype=jnp.int32))
        plan = jbuild_unet_plan(coords, jnp.ones((n,), bool), (n,) * 5, presorted=True)
        return jmodel.init(jax.random.PRNGKey(0), plan, jnp.zeros((n, 1)), train=False)

    shapes = jax.eval_shape(init)
    shapes = (shapes["params"], shapes["batch_stats"])
    ids = itertools.count()
    idt = jax.tree_util.tree_map(lambda _: next(ids), shapes)
    key_of = {i: k for k, i in jax_to_state_dict(*idt).items()}
    sd = model.state_dict()
    assert sorted(key_of.values()) == sorted(sd)

    def take(i, shape):
        v = sd[key_of[i]].detach().numpy()
        assert v.shape == shape.shape, (key_of[i], v.shape, shape.shape)
        return jnp.asarray(v)

    return jax.tree_util.tree_map(take, idt, shapes)


@functools.lru_cache(maxsize=None)
def _jax_init(head):
    """Numpy (params, batch_stats) of the JAX fine-tuning state at
    PRNGKey(0) for a `head`: the weights depend on nothing else of the
    config, so each worker compiles the JAX init once per head."""
    tcfg, jcfg = _cfgs("ExpMixCosineFineTuning" if head == "cosine" else "ExpFineTuning")
    state = jft.create_finetune_state(jax.random.PRNGKey(0), jcfg)
    return _np_tree((state.params, state.batch_stats))


def _jax_perms(base, step, n, count):
    """The permutations the JAX step draws: `fold_in(PRNGKey(base), step)`
    split in 3 (`finetune.py:142-145`, `feature_mixing.py:20-23`)."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(base), step), 3)
    return tuple(_t(jax.random.permutation(k, n)) for k in keys[:count])


# ------------------------------------------------------------------ blocks


def test_soft_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(300, 18)).astype(np.float32) * 3
    probs = rng.random((300, 18)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    valid = rng.random(300) < 0.7
    for v in (valid, None):
        ref = jl.soft_cross_entropy(jnp.asarray(logits), jnp.asarray(probs),
                                    None if v is None else jnp.asarray(v))
        got = tl.soft_cross_entropy(_t(logits), _t(probs), None if v is None else _t(v))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    assert float(tl.soft_cross_entropy(_t(logits), _t(probs), torch.zeros(300, dtype=bool))) == 0


def test_normed_linear_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    x[3] = 0.0  # the 1e-12 floor
    w = rng.uniform(-1, 1, (16, 5)).astype(np.float32)
    ref = jlayers.NormedLinear(5).apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x))
    layer = tlayers.NormedLinear(16, 5, generator=torch.Generator().manual_seed(0))
    assert layer.weight.shape == (16, 5)
    assert float(layer.weight.detach().abs().max()) <= 1
    with torch.no_grad():
        layer.weight.copy_(_t(w))
    _close(layer(_t(x)), ref, 1e-6)
    _eq(layer(_t(x))[3], np.zeros(5, np.float32))


def _mix_inputs(seed=2, n=500, c=12, k=18):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, c)).astype(np.float32)
    labels = rng.integers(-1, k, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    return feats, labels, valid


@pytest.mark.parametrize("fn", ["mix_features", "mix_features_beta", "mix_centroid_sup",
                                "mix_unsup_features", "mix_unsup_centroid"])
def test_feature_mixing_matches_jax(fn):
    """The JAX function's own draws (its key split in 3: permutations, then
    the Beta ratio) fed to the port's."""
    feats, labels, valid = _mix_inputs()
    n = feats.shape[0]
    key = jax.random.PRNGKey(7)
    k1, k2, k3 = jax.random.split(key, 3)
    perms = tuple(_t(jax.random.permutation(k, n)) for k in (k1, k2, k3))
    ratio = float(jax.random.beta(k3, 0.5, 0.5))
    f, lab, v = jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(valid)
    tf_, tlab, tv = _t(feats), _t(labels), _t(valid)
    if fn == "mix_features":
        ref = jfm.mix_features(key, f, lab, v, 18, 0.5, mixing_ratio=0.1)
        got = tfm.mix_features(None, tf_, tlab, tv, 18, 0.5, mixing_ratio=float(np.float32(0.1)),
                               perms=perms[:2])
    elif fn == "mix_features_beta":
        ref = jfm.mix_features(key, f, lab, v, 18, 0.5)
        got = tfm.mix_features(None, tf_, tlab, tv, 18, 0.5, perms=perms[:2], ratio=ratio)
    elif fn == "mix_centroid_sup":
        ref = jfm.mix_centroid_sup(key, f, lab, v, 17)
        got = tfm.mix_centroid_sup(None, tf_, tlab, tv, 17, perms=perms)
    elif fn == "mix_unsup_features":
        ref = jfm.mix_unsup_features(key, f, v, 17)
        got = tfm.mix_unsup_features(None, tf_, tv, 17, perms=perms[:2], ratio=ratio)
    else:
        ref = jfm.mix_unsup_centroid(key, f, v, 17)
        got = tfm.mix_unsup_centroid(None, tf_, tv, 17, perms=perms)
    assert 0 < int(ref[-1].sum()) < n
    _eq(got[-1], ref[-1], "ok")
    _close(got[0], ref[0], 1e-6, "mixed features")
    if got[1].dtype == torch.int32:
        _eq(got[1], ref[1], "labels")
    else:
        _close(got[1], ref[1], 1e-6, "soft targets")


def test_feature_mixing_draws_from_its_generator():
    """Without given draws: the permutations and ratio come from the
    generator, the same generator state gives the same mix, and the mixed
    features carry no gradient."""
    feats, labels, valid = _mix_inputs()
    x = _t(feats).requires_grad_()
    outs = [tfm.mix_features(torch.Generator().manual_seed(3), x, _t(labels), _t(valid), 18)
            for _ in range(2)]
    for a, b in zip(*outs):
        _eq(a.detach(), b.detach())
    assert not outs[0][0].requires_grad
    p = tfm.draw_perms(torch.Generator().manual_seed(3), 500, 2, "cpu")
    _eq(torch.sort(p[0]).values, torch.arange(500))


@pytest.mark.parametrize("a,b", [(0.5, 0.5), (2.0, 3.0), (0.3, 1.7)])
def test_beta_draw_law(a, b):
    """The port's Beta sampler against the Beta(a, b) law (Kolmogorov-Smirnov,
    3000 draws from one seeded generator)."""
    g = torch.Generator().manual_seed(11)
    draws = np.array([float(tfm.beta_draw(a, b, g, "cpu")) for _ in range(3000)])
    assert ((draws >= 0) & (draws <= 1)).all()
    assert scipy.stats.kstest(draws, scipy.stats.beta(a, b).cdf).pvalue > 1e-3


def test_centroid_mix_matches_jax():
    feats, labels, valid = _mix_inputs(seed=3)
    key = jax.random.PRNGKey(5)
    ref = jft._centroid_mix(key, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(valid), 17)
    perms = tuple(_t(jax.random.permutation(k, 500)) for k in jax.random.split(key, 3))
    got = tft._centroid_mix(_t(feats), _t(labels), _t(valid), 17, perms)
    _close(got[0], ref[0], 1e-6)
    _eq(got[1], ref[1])
    _eq(got[2], ref[2])


@pytest.mark.parametrize("head", ["linear", "cosine"])
def test_mixed_logits_and_head_gradients_match_jax(head):
    """The mixed rows reach `final` and `final2` through their raw
    parameters: values and the gradients of a weighted sum."""
    tcfg, jcfg = _cfgs("ExpMixFineTuning", head=head)
    model = tft.make_model(tcfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    mixf = rng.normal(size=(200, PLANES[-1])).astype(np.float32)
    mixf[:20] = 0.0  # rows that failed the mix test
    wts = rng.normal(size=(200, 18)).astype(np.float32)
    params = {h: {k: jnp.asarray(v.detach().numpy()) for k, v in
                  getattr(model.encoder, h).named_parameters()} for h in ("final", "final2")}

    def jfn(p):
        return jnp.sum(jft._mixed_logits(jcfg, p, jnp.asarray(mixf)) * jnp.asarray(wts))

    ref = jft._mixed_logits(jcfg, params, jnp.asarray(mixf))
    jgrad = jax.grad(jfn)(params)
    got = tft._mixed_logits(tcfg, model, _t(mixf))
    _close(got, ref, 1e-6)
    (got * _t(wts)).sum().backward()
    for h in ("final", "final2"):
        for k, p in getattr(model.encoder, h).named_parameters():
            assert p.grad is not None and float(p.grad.abs().max()) > 0, (h, k)
            _close(p.grad, jgrad[h][k], 1e-5, f"{h}.{k}")


@pytest.mark.parametrize("coeffs", [(1.0, 0.0), (0.0, 1.0), (1.0, 1e-6)],
                         ids=["id_alone", "ood_alone", "recipe"])
def test_entropy_terms_match_jax(coeffs):
    """Each term alone (the ood term is a masked SUM with a 1e-6 weight in
    the recipes, so it would hide inside the total's tolerance)."""
    tcfg, jcfg = _cfgs("ExpMixExtraFineTuning", id_entropy_coeff=coeffs[0],
                       ood_entropy_coeff=coeffs[1])
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(400, 18)) * 4).astype(np.float32)
    valid = rng.random(400) < 0.6
    ref = float(jft._entropy_terms(jcfg, jnp.asarray(logits), jnp.asarray(valid)))
    got = float(tft._entropy_terms(tcfg, _t(logits), _t(valid)))
    assert ref != 0
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("schedule", ["const", "linear"])
def test_mix_ratio_matches_jax(schedule):
    tcfg, jcfg = _cfgs("ExpMixFineTuning", mix_schedule=schedule, mixing_ratio=0.3)
    for step in range(0, 9):  # past the end of training: clipped
        assert tft._mix_ratio(tcfg, step) == float(jft._mix_ratio(jcfg, jnp.asarray(step)))


@pytest.mark.parametrize("schedule", ["const", "step", "poly", "linear"])
def test_threshold_matches_jax(schedule):
    """Every step of 8 epochs and past their end; the `step` schedule updates
    on even epochs from epoch 0."""
    tcfg, jcfg = _cfgs("ExpMixExtraFineTuning", thr_schedule=schedule, steps_per_epoch=3,
                       epochs=8, thr_init=0.13, thr_end=0.61)
    got = [tft._threshold(tcfg, s) for s in range(30)]
    ref = [float(jft._threshold(jcfg, jnp.asarray(s))) for s in range(30)]
    assert got == ref
    if schedule != "const":
        assert len(set(got)) > 4


@pytest.mark.parametrize("mode", ["threshold", "rc_oracle"])
def test_pseudo_label_rules(mode):
    """`_pseudo_labels` against the rules as the JAX step writes them
    (`gcdlss_tpu/train/finetune.py:398-421`), bit for bit."""
    tcfg, _ = _cfgs("ExpRCExtra" if mode == "rc_oracle" else "ExpMixExtraFineTuning")
    rng = np.random.default_rng(6)
    probs = jax.nn.softmax(jnp.asarray(rng.normal(size=(600, 18)) * 3, jnp.float32), -1)
    mapped = jnp.asarray(rng.integers(-1, 18, 600).astype(np.int32))
    unsup = jnp.asarray(rng.random(600) < 0.5)
    thr, unk = tft._threshold(tcfg, 0), tcfg.unknown_label
    if mode == "rc_oracle":
        rows = unsup & (mapped == unk)
        ref = jnp.where(rows, jnp.where(probs[:, -1] > thr, unk, -1), -1)
    else:
        rows = unsup
        ref = jnp.where(probs[:, -1] > thr, unk, jnp.argmax(probs, axis=-1).astype(jnp.int32))
        ref = jnp.where(unsup, ref, -1)
    pseudo, trows = tft._pseudo_labels(tcfg, _t(probs), _t(mapped), _t(unsup), thr)
    _eq(pseudo, ref)
    _eq(trows, rows)
    assert int((np.asarray(ref) == unk).sum()) > 0


# ------------------------------------------------------------- the steps


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_s15"))
    write_synthetic_kitti(root, sequences=("00",), scans_per_seq=4, num_points=900, seed=2)
    meta = dataset_meta("SemanticKITTI")
    unknown, _ = split_table("SemanticKITTI", 1)
    mapping, inv, unk = build_label_mapping(unknown, meta["learning_map_inv"].keys())
    assert unk == LABEL_SPACE["unknown_label"]
    dskw = dict(voxel_size=0.15, label_mapping=mapping, unknown_labels=unknown)

    def datasets(cls):
        return dict(
            lab=cls(root, "train", split_indices=np.array([0, 1]), labeled=True,
                    downsampling=800, augment=True, resize_aug=True, seed=0, **dskw),
            unlab=cls(root, "train", split_indices=np.array([0, 1]), labeled=False,
                      downsampling=800, augment=True, seed=1, **dskw),
            rank=cls(root, "train", split_indices=np.array([0]), labeled=False, **dskw),
            val=cls(root, "valid", **dskw))

    jds = datasets(SemanticKITTIDataset)
    return dict(
        root=root, mapping=mapping, inv=inv, unknown=unknown, jds=jds,
        tds=datasets(TorchSemanticKITTIDataset),
        plain=collate_batch([jds["lab"][0], jds["lab"][1]], CAPS[0]),
        sup=collate_batch([jds["lab"][0], jds["lab"][1]], SUP_CAP),
        unsup=collate_batch([jds["unlab"][0], jds["unlab"][1]], CAPS[0] - SUP_CAP),
        # the cluster miner's sides: one labeled scan (pad rows mid-stream),
        # two blobby unlabeled scans (DBSCAN finds >= K + 1 clusters in each)
        sup_one=collate_batch([jds["lab"][0]], SUP_CAP),
        blobs=_blob_side(np.random.default_rng(12), CAPS[0] - SUP_CAP))


def _blob_side(rng, cap, scans=2, blobs=40):
    """A voxel batch (numpy dict) of `scans` scans of `blobs` tight blobs
    each: unique coordinates in plan order, 90% of `cap`."""
    centers = rng.uniform(-60, 60, size=(scans, blobs, 3))
    b = np.sort(rng.integers(0, scans, 2 * cap))
    pts = centers[b, rng.integers(0, blobs, 2 * cap)] + rng.normal(0, 1.0, (2 * cap, 3))
    c = np.unique(np.concatenate([b[:, None], np.floor(pts)], 1).astype(np.int32), axis=0)
    c = c[:int(cap * 0.9)]
    coords = np.zeros((cap, 4), np.int32)
    coords[:len(c)] = c
    valid = np.arange(cap) < len(c)
    labels = np.where(valid, rng.integers(0, 19, cap), -1).astype(np.int32)
    return {"coords": coords, "feats": rng.uniform(0, 1, (cap, 1)).astype(np.float32),
            "labels": labels, "mapped_labels": labels, "valid": valid}


def _jax_cluster_twin(tb, tcfg):
    """The JAX miner with the plan rows' coordinates in place of the input
    rows' the JAX step hands it (`gcdlss_tpu/train/finetune.py:405-409`):
    the rows its mask and features are in, as the port passes them."""
    combined = _combine_batches(*tb, tcfg)
    plan, _, _, _ = tcommon.plan_and_gather(combined, tcfg.voxel_caps)
    ok = plan.rep < combined["coords"].shape[0]
    coords0 = combined["coords"][torch.where(ok, plan.rep, 0).long()].numpy()
    miner = jft._cluster_unknown_mask_host

    def twin(coords, unsup, feats, probs_known):
        assert coords.shape == coords0.shape
        mask = miner(coords0, unsup, feats, probs_known)
        twin.masked.append(int(mask.sum()))
        return mask

    twin.masked = []
    return twin


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def run(request, data):
    """The variant's steps in both packages from the JAX initial state at
    PRNGKey(0) (as the Stage-1 and Stage-2 parity tests start), and the
    port's steps again from that state scaled by 1 + 1e-7 noise."""
    name, steps, extra = VARIANTS[request.param]
    tcfg, jcfg = _cfgs(name)
    assert (tcfg.sup_voxel_cap > 0) == extra
    tstate = tft.create_finetune_state(0, tcfg, device="cpu")
    load_jax_params(tstate.model, *_jax_init(tcfg.head))
    if tcfg.extra_mode == "rc_oracle":  # NCC probs past its threshold, 0.21
        _spread_ncc(tstate.model)
    sd0 = {k: v.detach().clone() for k, v in tstate.model.state_dict().items()}
    # the JAX state holds the same weights, fresh SGD state, step 0
    params, stats = _jax_trees(jft.make_model(jcfg), tstate.model)
    jstate = jcommon.TrainState(
        params=params, batch_stats=stats, step=jnp.zeros((), jnp.int32),
        opt_state=jcommon.make_sgd(jcfg, jschedule.make_lr_schedule(jcfg)).init(params))
    patch = pytest.MonkeyPatch()
    if extra:
        jb = [jcommon.voxel_batch_to_device(data[s]["voxel"]) for s in ("sup", "unsup")]
        tb = [tcommon.voxel_batch_to_device(data[s]["voxel"], "cpu") for s in ("sup", "unsup")]
        jstep, tstep, base = jft.finetune_extra_train_step, tft.finetune_extra_train_step, 4321
        if tcfg.extra_mode == "cluster":
            keys = ("coords", "feats", "labels", "mapped_labels", "valid")
            sides = [{k: np.asarray(getattr(data["sup_one"]["voxel"], k)) for k in keys},
                     data["blobs"]]
            jb = [{k: jnp.asarray(v) for k, v in side.items()} for side in sides]
            tb = [{k: _t(v) for k, v in side.items()} for side in sides]
            twin = _jax_cluster_twin(tb, tcfg)
            patch.setattr(jft, "_cluster_unknown_mask_host", twin)
    else:
        jb = [jcommon.voxel_batch_to_device(data["plain"]["voxel"])]
        tb = [tcommon.voxel_batch_to_device(data["plain"]["voxel"], "cpu")]
        jstep, tstep, base = jft.finetune_train_step, tft.finetune_train_step, 1234
    count = {"pairs": 2, "centroid": 3}.get(tcfg.mix_mode, 0)
    perms = [_jax_perms(base, step, CAPS[0], count) for step in range(steps)]
    out = []
    for step in range(steps):
        with patch.context():
            jstate, jm = jstep(jstate, *jb, jcfg)
        tstate, tm = tstep(tstate, *tb, tcfg, draws={"perms": perms[step]})
        out.append(dict(jm={k: float(v) for k, v in jm.items()},
                        tm={k: float(v) for k, v in tm.items()},
                        jsd=jax_to_state_dict(*_np_tree((jstate.params, jstate.batch_stats))),
                        tsd={k: v.detach().clone() for k, v in
                             tstate.model.state_dict().items()}))
    assert tstate.step == steps == int(jstate.step)
    patch.undo()

    pstate = tft.create_finetune_state(0, tcfg, device="cpu")
    pstate.model.load_state_dict(sd0)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in pstate.model.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g))
    for step in range(steps):
        pstate, _ = tstep(pstate, *tb, tcfg, draws={"perms": perms[step]})
    response = max(float((v - out[-1]["tsd"][k]).abs().max()
                         / out[-1]["tsd"][k].abs().max().clamp(min=1e-6))
                   for k, v in pstate.model.state_dict().items())
    if tcfg.extra_mode == "cluster":  # the miner marked rows unknown
        assert twin.masked and min(twin.masked) > 0, twin.masked
    return dict(name=request.param, cfg=tcfg, steps=out, response=response,
                sd0={k: v.numpy() for k, v in sd0.items()})


def test_steps_are_well_conditioned(run):
    """The parameter comparison below means something only where the steps
    do not amplify rounding: from the fixture's initial state, a 1e-7
    relative perturbation of the weights moves no tensor by more than 1e-5 of
    its largest magnitude after the variant's steps, port against port. (At
    other initial states it need not hold: from PRNGKey(1) the plain step
    moves a batch-norm bias by 4.6e-3 of its max after two steps.)"""
    assert run["response"] < 1e-5


def test_step_losses_match_jax(run):
    for s in run["steps"]:
        assert set(s["tm"]) == set(s["jm"])
        for k, ref in s["jm"].items():
            assert np.isfinite(s["tm"][k]), k
            np.testing.assert_allclose(s["tm"][k], ref, rtol=1e-5, atol=1e-6, err_msg=k)
    if run["cfg"].sup_voxel_cap > 0:
        assert any(s["jm"]["unsup_seg"] > 0 for s in run["steps"])


def test_step_params_and_stats_match_jax(run):
    """Every parameter and batch-norm statistic after each step; the heads'
    updates on their own scale, which a detached head would miss."""
    for s in run["steps"]:
        assert set(s["tsd"]) == set(s["jsd"])
        for k, ref in s["jsd"].items():
            _close(s["tsd"][k], ref, 1e-4, k)
    first = run["steps"][0]
    for k, v0 in run["sd0"].items():
        if k.startswith(("encoder.final.", "encoder.final2.")):
            delta = first["jsd"][k] - v0
            assert np.abs(delta).max() > 0, k
            _close(first["tsd"][k].numpy() - v0, delta, 1e-3, f"update of {k}")


# ------------------------------------------------------ host loop, eval


def test_exp_finetuning_epochs(data):
    """The host loop over the port's datasets and loaders: a plain epoch and
    an Extra epoch, each read once at its end; an epoch of the fixture's
    batch gives the loss of `finetune_train_step` from the same weights (the
    step is held to the JAX one above)."""
    tcfg, _ = _cfgs("ExpFineTuning")
    vb = tcommon.voxel_batch_to_device(data["plain"]["voxel"], "cpu")
    _, m = tft.finetune_train_step(tft.create_finetune_state(0, tcfg, device="cpu"), vb, tcfg)
    exp = tft.ExpFineTuning(tcfg, seed=0, device="cpu")
    means = exp.train_epoch([data["plain"]])
    np.testing.assert_allclose(means["loss"], float(m["loss"]), rtol=1e-6)

    for name in ("ExpFineTuning", "ExpMixExtraFineTuning"):
        cfg, _ = _cfgs(name, planes=(8,) * 8)
        exp = tft.ExpFineTuning(cfg, seed=0, device="cpu")
        loaders = exp.make_loaders(data["tds"]["lab"], data["tds"]["unlab"], batch_size=2,
                                   num_workers=1)
        assert len(loaders) == (2 if exp.extra else 1)
        means = exp.train_epoch(*loaders)
        assert len(exp.step_log) == 1 and np.isfinite(means["loss"])
        keys = {"loss", "seg", "calib"} | ({"unsup_seg", "thr"} if exp.extra else set())
        assert set(exp.step_log[0]) == keys | {"step_ms"} and exp.step_log[0]["step_ms"] > 0
    with pytest.raises(ValueError, match="unlabeled"):
        exp.train_epoch(loaders[0])


@pytest.fixture(scope="module")
def eval_models(data):
    """JAX trees of a fine-tuning state whose NCC column spreads across the
    sweep's thresholds (its `final2` scaled), and the port's model with them."""
    tcfg, jcfg = _cfgs("ExpRCTest")
    model = tft.make_model(tcfg, torch.Generator().manual_seed(3))
    _spread_ncc(model)
    params, stats = _jax_trees(jft.make_model(jcfg), model)
    return dict(tcfg=tcfg, jcfg=jcfg, params=params, stats=stats, model=model)


def test_uncertainty_ranking_matches_jax(data, eval_models, tmp_path):
    e = eval_models
    assert len(data["jds"]["rank"]) == len(data["tds"]["rank"]) == 3
    jorder, jscores = junc.rank_uncertain_scans(e["params"], e["stats"], data["jds"]["rank"],
                                                e["jcfg"], CAPS[0])
    out = tmp_path / "order.npy"
    torder, tscores = tunc.rank_uncertain_scans(e["model"], data["tds"]["rank"], e["tcfg"],
                                                CAPS[0], str(out))
    np.testing.assert_allclose(tscores, jscores, rtol=1e-5)
    assert len(set(np.round(jscores, 4))) == 3  # a strict order
    _eq(torder, jorder)
    _eq(np.load(out), jorder)


def test_threshold_sweep_matches_jax(data, eval_models):
    e = eval_models
    known = [k for k, v in data["mapping"].items() if v != LABEL_SPACE["unknown_label"]]
    unknown = [k for k, v in data["mapping"].items() if v == LABEL_SPACE["unknown_label"]]
    ref = jsweep.threshold_sweep_test(e["params"], e["stats"], data["jds"]["val"], e["jcfg"],
                                      data["inv"], known, unknown, point_cap=1024)
    got = tsweep.threshold_sweep_test(e["model"], data["tds"]["val"], e["tcfg"], data["inv"],
                                      known, unknown, point_cap=1024)
    assert list(got) == list(ref) == list(tsweep.DEFAULT_THRESHOLDS)
    for t, r in ref.items():
        for k in ("mIoU", "mIoU_old", "mIoU_new"):
            np.testing.assert_allclose(got[t][k], r[k], rtol=0, atol=1e-6, err_msg=f"{t} {k}")
        assert got[t]["conf"].sum() > 0
    # the thresholds cut the NCC column at different points
    assert len({round(r["mIoU"], 6) for r in ref.values()}) > 2


@pytest.mark.parametrize("route", ["sklearn", "fallback"])
def test_subdivided_sweep_matches_jax(data, eval_models, route, monkeypatch):
    """ExpMixExtraTest's sweep (`subdivide=True`): the predicted-novel
    points split in two by KMeans(2) over their features, or, with
    scikit-learn hidden from both packages, at the median of the feature
    sums; mIoUs within 1e-6 of the JAX sweep's at every threshold."""
    import sys

    if route == "fallback":
        monkeypatch.setitem(sys.modules, "sklearn", None)
        monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    e = eval_models
    known = [k for k, v in data["mapping"].items() if v != LABEL_SPACE["unknown_label"]]
    unknown = [k for k, v in data["mapping"].items() if v == LABEL_SPACE["unknown_label"]]
    assert len(unknown) == 2
    ref = jsweep.threshold_sweep_test(e["params"], e["stats"], data["jds"]["val"], e["jcfg"],
                                      data["inv"], known, unknown, subdivide=True,
                                      point_cap=1024)
    got = tsweep.threshold_sweep_test(e["model"], data["tds"]["val"], e["tcfg"], data["inv"],
                                      known, unknown, subdivide=True, point_cap=1024)
    plain = tsweep.threshold_sweep_test(e["model"], data["tds"]["val"], e["tcfg"], data["inv"],
                                        known, unknown, point_cap=1024)
    for t, r in ref.items():
        for k in ("mIoU", "mIoU_old", "mIoU_new"):
            np.testing.assert_allclose(got[t][k], r[k], rtol=0, atol=1e-6, err_msg=f"{t} {k}")
    # the split sends points to the second novel class: other confusions
    assert any(not np.array_equal(got[t]["conf"], plain[t]["conf"]) for t in got)


# --------------------------------------------- registry, warm start, refusals


def test_registry_matches_jax():
    assert treg.MODULE_REGISTRY == jreg.MODULE_REGISTRY
    names = list(jreg.MODULE_REGISTRY) + ["MyFineTuning", "FooDiscoverBar", "NewPretrain"]
    for name in names:
        assert treg.resolve_module(name) == jreg.resolve_module(name), name
    with pytest.raises(NameError):
        treg.resolve_module("Nothing")


def test_finetune_config_follows_main():
    """What `main.py:277-300` builds: the Extra split at half of cap0 and
    batch_size // 2 scans a side, the nuScenes calibration weight, the
    recipe's own values last."""
    kw = dict(voxel_caps=CAPS, batch_size=6, **LABEL_SPACE)
    stage, cfg = treg.finetune_config("ExpMixExtraStepSchedulingFineTuning", **kw)
    assert stage == "finetune_extra"
    assert (cfg.sup_voxel_cap, cfg.num_sup_scans, cfg.thr_schedule) == (1024, 3, "step")
    assert (cfg.mix_mode, cfg.entropy_minimize, cfg.calib_coeff) == ("pairs", True, 0.05)
    _, cfg = treg.finetune_config("ExpRCExtra", dataset="nuScenes", **kw)
    assert (cfg.calib_coeff, cfg.extra_mode, cfg.thr_init) == (0.01, "rc_oracle", 0.21)
    stage, cfg = treg.finetune_config("ExpFineTuning", dataset="nuScenes", **kw)
    assert (stage, cfg.calib_coeff, cfg.sup_voxel_cap) == ("finetune", 0.15, 0)
    assert treg.finetune_config("ExpUncertaintyCheck", **kw)[0] == "uncertainty"
    assert treg.finetune_config("ExpRCTest", **kw)[0] == "finetune_test"
    for name in ("ExpPretrain", "ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive"):
        with pytest.raises(ValueError):
            treg.finetune_config(name, **kw)


def test_warm_start_from_jax_stage1():
    """A JAX Stage-1 state carried into both packages: the same Stage-1.5
    `encoder` and `final` parameters; batch-norm statistics, `final2` and
    `final3` stay those of a fresh model."""
    pkw = dict(voxel_caps=CAPS, arch="MinkUNet14", planes=PLANES, **LABEL_SPACE)
    seg = tpt.create_pretrain_state(0, tpt.PretrainConfig(**pkw), device="cpu").model
    with torch.no_grad():
        seg.encoder.bn0.running_mean.add_(5.0)
    sparams, sstats = _np_tree(_jax_trees(jpt.make_model(jpt.PretrainConfig(**pkw)), seg))
    tcfg, jcfg = _cfgs("ExpFineTuning")
    jstate = jft.create_finetune_state(jax.random.PRNGKey(1), jcfg, sparams)
    ref = jax_to_state_dict(*_np_tree((jstate.params, jstate.batch_stats)))
    got = tft.create_finetune_state(1, tcfg, pretrained=seg.state_dict(), device="cpu")
    fresh = tft.make_model(tcfg, torch.Generator().manual_seed(1)).state_dict()
    stage1 = jax_to_state_dict(sparams, sstats)
    params = dict(got.model.named_parameters())
    for k, v in got.model.state_dict().items():
        if k in params and not k.startswith(("encoder.final2.", "encoder.final3.")):
            _eq(v, ref[k], k)
            _eq(v, stage1[k], k)
        else:  # fresh in both packages: statistics 0 / 1, heads drawn anew
            _eq(v, fresh[k], k)
            if k not in params:
                _eq(v, ref[k], k)
    assert float(got.model.encoder.bn0.running_mean.abs().max()) == 0


def test_cosine_heads_cross_the_bridge():
    """ExpCosinePretrain and a cosine MinkUNetRC: the JAX trees and the
    port's have the same keys and shapes (`final.weight`, `final2.weight`;
    the JAX-made values cross in the pairs_cosine step fixture), and a cosine
    pretrain step runs."""
    pkw = dict(voxel_caps=CAPS, arch="MinkUNet14", planes=PLANES, **LABEL_SPACE)
    _, overrides = treg.resolve_module("ExpCosinePretrain")
    pcfg = tpt.PretrainConfig(**pkw, **overrides)
    state = tpt.create_pretrain_state(0, pcfg, device="cpu")
    assert isinstance(state.model.encoder.final, tlayers.NormedLinear)
    # the JAX cosine MinkUNetSeg's trees: every key and shape the port's
    tree = _np_tree(_jax_trees(jpt.make_model(jpt.PretrainConfig(**pkw, **overrides)),
                               state.model))
    assert tree[0]["final"]["weight"].shape == (PLANES[-1], 17)
    load_jax_params(state.model, *tree)  # strict
    rng = np.random.default_rng(8)
    coords = np.zeros((CAPS[0], 4), np.int32)
    coords[:, 1:] = rng.integers(0, 40, (CAPS[0], 3))
    coords = np.unique(coords, axis=0)
    n = coords.shape[0]
    pad = np.zeros((CAPS[0] - n, 4), np.int32)
    batch = {"coords": _t(np.concatenate([coords, pad])),
             "feats": torch.rand(CAPS[0], 1, generator=torch.Generator().manual_seed(0)),
             "labels": torch.zeros(CAPS[0], dtype=torch.int32),
             "mapped_labels": _t(rng.integers(0, 17, CAPS[0]).astype(np.int32)),
             "valid": torch.arange(CAPS[0]) < n}
    _, m = tpt.pretrain_train_step(state, batch, pcfg)
    assert np.isfinite(float(m["loss"]))

    tcfg, jcfg = _cfgs("ExpMixCosineFineTuning")
    model = tft.make_model(tcfg)
    # the JAX cosine MinkUNetRC's trees: every key and shape the port's
    load_jax_params(model, *_np_tree(_jax_trees(jft.make_model(jcfg), model)))
    assert isinstance(model.encoder.final2, tlayers.NormedLinear)
    assert isinstance(model.encoder.final3, tlayers.Linear)
    # a reference-layout dict carries the cosine heads' `weight` too
    w = torch.rand(PLANES[-1], 17, generator=torch.Generator().manual_seed(1))
    missing = load_reference_state_dict(model, {"encoder.final.weight": w.numpy()},
                                        me_order="last_fastest")
    _eq(model.encoder.final.weight, w)
    assert "encoder.final.weight" not in missing and "encoder.final2.weight" in missing


def test_refusals_name_their_roadmap_item():
    """The three Stage-1.5 / single-model recipes once refused here build as
    the JAX package's `main.py` builds them: ExpClusterFineTuning's config
    (`extra_mode="cluster"`) and model, ExpMixExtraTest's sweep flag
    (`subdivide_novel`, read from the recipe) and ExpDiscover's
    `NopsConfig`; a value no recipe has still raises."""
    tcfg, jcfg = _cfgs("ExpClusterFineTuning")
    assert (tcfg.extra_mode, tcfg.unsup_coeff, tcfg.sup_voxel_cap) == ("cluster", 0.1, SUP_CAP)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert isinstance(tft.make_model(tcfg), tft.MinkUNetRC)
    # remat is ported: the state builds with its blocks recomputed in backward
    assert tft.create_finetune_state(0, dataclasses.replace(tcfg, remat=True),
                                     device="cpu").model.encoder.block1.remat
    stage, cfg = treg.finetune_config("ExpMixExtraTest", voxel_caps=CAPS, batch_size=4,
                                      **LABEL_SPACE)
    overrides = dict(jreg.MODULE_REGISTRY["ExpMixExtraTest"][1])
    assert stage == "finetune_test" and treg.subdivide_novel("ExpMixExtraTest")
    assert overrides.pop("subdivide_novel") and not treg.subdivide_novel("ExpRCTest")
    assert all(getattr(cfg, k) == v for k, v in overrides.items())
    stage, ncfg = treg.nops_config("ExpDiscover", voxel_caps=CAPS, batch_size=4, num_classes=19,
                                   num_labeled_classes=17, num_unlabeled_classes=2,
                                   unknown_label=17)
    ref = jnops.NopsConfig(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                           unknown_label=17, voxel_caps=CAPS, sup_voxel_cap=SUP_CAP,
                           num_sup_scans=2)
    assert stage == "nops" and dataclasses.asdict(ncfg) == dataclasses.asdict(ref)
    with pytest.raises(ValueError):
        treg.finetune_config("ExpDiscover", voxel_caps=CAPS, batch_size=4, **LABEL_SPACE)
    for bad in (dict(mix_mode="feature"), dict(extra_mode="dbscan")):
        with pytest.raises(ValueError):
            tft.make_model(dataclasses.replace(tcfg, **bad))
