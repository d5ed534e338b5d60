"""PyTorch port vs JAX package: the bottleneck model family (MinkUNet50 /
101), the weights bridge both ways, `remat` and the logit assemblers.

MinkUNet50 runs with narrow planes (8 everywhere; the bottleneck stages are
then 32 wide) on a small synthetic plan, train- and eval-mode batch norm;
the JAX side runs eagerly (no compile). The port runs its plain kernel
versions here. Tolerances: the existing 1e-4 of the reference's scale for
conv outputs, f32 summation order only; `remat` against no `remat` is
port against port, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcdlss_tpu.models import minkunet as jmk
from gcdlss_tpu.ops.plan import build_unet_plan as jax_plan
from gcdlss_tpu_torch.models import minkunet as tmk
from gcdlss_tpu_torch.ops.plan import build_unet_plan as torch_plan
from gcdlss_tpu_torch.train import pretrain as tpt
from gcdlss_tpu_torch.utils.weights import (jax_to_state_dict, load_jax_params,
                                            state_dict_to_jax)

CAPS = (2048, 1536, 1024, 512, 512)
NARROW = (8,) * 8
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one CPU thread while this module's tests run
    (the suite runs several workers at once; each worker's default pool
    would oversubscribe the cores). Restored when the module's tests end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def inputs():
    """Two synthetic scans at 0.3 m voxels in (b, x, y, z) order, 1-channel
    features, and both packages' plans of them (bit-equal integer books)."""
    rng = np.random.default_rng(0)
    rows = []
    for b in range(2):
        pts = rng.uniform([-12, -12, -2], [12, 12, 2], (1500, 3))
        vc = np.unique(np.floor(pts / 0.3).astype(np.int32), axis=0)
        rows.append(np.concatenate([np.full((len(vc), 1), b, np.int32), vc], 1))
    vc = np.concatenate(rows)[:CAPS[0]]
    coords = np.zeros((CAPS[0], 4), np.int32)
    coords[:len(vc)] = vc
    valid = np.arange(CAPS[0]) < len(vc)
    feats = (rng.uniform(0, 1, (CAPS[0], 1)) * valid[:, None]).astype(np.float32)
    jplan = jax_plan(jnp.asarray(coords), jnp.asarray(valid), CAPS, presorted=True)
    tplan = torch_plan(torch.as_tensor(coords), torch.as_tensor(valid), CAPS, presorted=True)
    np.testing.assert_array_equal(tplan.levels[1].nbr3.numpy(), np.asarray(jplan.levels[1].nbr3))
    return dict(feats=feats, jplan=jplan, tplan=tplan)


def _close(got, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=TOL * max(np.abs(ref).max(), 1e-6), err_msg=what)


@pytest.mark.parametrize("train", [True, False])
def test_bottleneck_block_matches_jax(inputs, train):
    """One `Bottleneck` with a projection (16 -> 4 x 8 channels) on the L1 k3
    book: output and, in train mode, the updated batch statistics."""
    plan = inputs["tplan"]
    nbr, valid = plan.levels[1].nbr3, plan.levels[1].valid
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((valid.shape[0], 16)) * valid.numpy()[:, None]).astype(np.float32)
    jblock = jmk.Bottleneck(8)
    variables = jblock.init(jax.random.PRNGKey(3), jnp.asarray(x),
                            jnp.asarray(nbr.numpy()), jnp.asarray(valid.numpy()), train)
    params, stats = _np_tree(variables["params"]), _np_tree(variables["batch_stats"])
    # train-mode BN statistics that are not the init's, so eval mode reads them
    stats = jax.tree_util.tree_map(lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(a.dtype),
                                   stats)
    ref, upd = jblock.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            jnp.asarray(nbr.numpy()), jnp.asarray(valid.numpy()), train,
                            mutable=["batch_stats"])
    block = tmk.Bottleneck(16, 8, torch.float32).train(train)
    sd = jax_to_state_dict({"encoder": {"block1": {"block0": params}}},
                           {"encoder": {"block1": {"block0": stats}}})
    block.load_state_dict({k.removeprefix("encoder.block1.0."): torch.as_tensor(np.array(v))
                           for k, v in sd.items()}, strict=True)
    assert {"conv1.kernel", "conv3.kernel", "downsample.0.kernel"} <= set(block.state_dict())
    assert tuple(block.conv1.kernel.shape) == (16, 8) and tuple(block.conv3.kernel.shape) == (8, 32)
    got = block(torch.as_tensor(x), nbr, valid)
    _close(got, ref, "out")
    if train:
        new = jax_to_state_dict({"encoder": {"block1": {"block0": params}}},
                                {"encoder": {"block1": {"block0": _np_tree(upd["batch_stats"])}}})
        for k, v in block.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), new[f"encoder.block1.0.{k}"], rtol=1e-5,
                                           atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def mink50(inputs):
    """JAX MinkUNetSeg / MinkUNetRC at MinkUNet50 with narrow planes: their
    initial trees, their eval- and train-mode outputs, eagerly."""
    out = {}
    feats, jplan = jnp.asarray(inputs["feats"]), inputs["jplan"]
    for kind, model in (("seg", jmk.MinkUNetSeg(17, arch="MinkUNet50", planes=NARROW)),
                        ("rc", jmk.MinkUNetRC(17, 2, arch="MinkUNet50", planes=NARROW))):
        variables = model.init(jax.random.PRNGKey(0), jplan, feats, train=False)
        tree = {"params": _np_tree(variables["params"]),
                "batch_stats": _np_tree(variables["batch_stats"])}
        ev = model.apply(tree, jplan, feats, train=False)
        tr, upd = model.apply(tree, jplan, feats, train=True, mutable=["batch_stats"])
        out[kind] = dict(tree=tree, eval=_np_tree(ev), train=_np_tree(tr),
                         stats=_np_tree(upd["batch_stats"]))
    return out


def _port_model(kind: str, remat: bool = False):
    if kind == "seg":
        return tmk.MinkUNetSeg(17, arch="MinkUNet50", planes=NARROW, remat=remat)
    return tmk.MinkUNetRC(17, 2, arch="MinkUNet50", planes=NARROW, remat=remat)


@pytest.mark.parametrize("kind", ["seg", "rc"])
@pytest.mark.parametrize("train", [True, False])
def test_mink50_forward_matches_jax(inputs, mink50, kind, train):
    """The whole MinkUNet50 (23 bottlenecks, widths 32 .. 32 x 4) from the
    JAX weights: every output, and in train mode every updated statistic."""
    ref = mink50[kind]
    model = _port_model(kind)
    load_jax_params(model, ref["tree"]["params"], ref["tree"]["batch_stats"])
    assert model.encoder.out_channels == 32
    model.train(train)
    with torch.no_grad():
        got = model(inputs["tplan"], torch.as_tensor(inputs["feats"]))
    want = ref["train" if train else "eval"]
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, k)
    if train:
        new = jax_to_state_dict(ref["tree"]["params"], ref["stats"])
        for k, v in model.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), new[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ["MinkUNet50", "MinkUNet101"])
def test_weights_bridge_round_trip(mink50, arch):
    """JAX trees -> port state dict -> JAX trees is the identity, and so is
    the other way round, bottleneck names and [Ci, Co] dense kernels
    included; MinkUNet101 builds (23 blocks at L4) and its dict survives."""
    tree = mink50["rc"]["tree"]
    if arch == "MinkUNet50":
        back = state_dict_to_jax(jax_to_state_dict(tree["params"], tree["batch_stats"]))
        for got, want in zip(back, (tree["params"], tree["batch_stats"])):
            got, want = _flat(got), _flat(want)
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    model = tmk.MinkUNetRC(17, 2, arch=arch, planes=NARROW)
    assert len(model.encoder.block4) == (6 if arch == "MinkUNet50" else 23)
    sd = model.state_dict()
    back = jax_to_state_dict(*state_dict_to_jax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v.numpy(), err_msg=k)
    # block5.0: the up conv's 8 channels and the 32 of the skip in, 4 x 8 out
    assert sd["encoder.block5.0.conv1.kernel"].shape == (40, 8)
    assert sd["encoder.block5.0.conv2.kernel"].shape == (27, 8, 8)
    assert sd["encoder.block5.0.conv3.kernel"].shape == (8, 32)
    assert sd["encoder.block5.0.downsample.0.kernel"].shape == (40, 32)


@pytest.mark.parametrize("arch", ["MinkUNet14", "MinkUNet50"])
def test_remat_changes_no_loss_or_gradient(inputs, arch):
    """A train step's loss, every gradient and every batch-norm statistic
    with `remat=True` equal those without, bit for bit: the recompute in the
    backward pass updates no running statistic a second time."""
    cfg = tpt.PretrainConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                             voxel_caps=CAPS, arch=arch, planes=NARROW)
    rng = np.random.default_rng(2)
    targets = torch.as_tensor(rng.integers(-1, 17, CAPS[0]).astype(np.int64))
    feats = torch.as_tensor(inputs["feats"])
    plan = inputs["tplan"]
    results = []
    for remat in (False, True):
        model = tpt.make_model(dataclasses.replace(cfg, remat=remat),
                               torch.Generator().manual_seed(0)).train()
        assert all(layer.remat == remat for layer in model.modules()
                   if isinstance(layer, tmk.ResLayer))
        out = model(plan, feats)
        loss = torch.nn.functional.cross_entropy(out["logits"], targets, ignore_index=-1)
        loss.backward()
        results.append((loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()},
                        {n: b.clone() for n, b in model.named_buffers()}))
    (l0, g0, b0), (l1, g1, b1) = results
    assert torch.equal(l0, l1)
    assert set(g0) == set(g1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for n in b0:
        assert torch.equal(b0[n], b1[n]), n
    # the statistics moved (one update, not none)
    stat = b0["encoder.block1.0.norm1.running_mean"]
    assert not torch.equal(stat, torch.zeros_like(stat))


def test_remat_builds_where_it_was_refused():
    """`remat=True` is a config value of every stage now."""
    from gcdlss_tpu_torch.train import discover as td
    from gcdlss_tpu_torch.train import finetune as tft

    fcfg = tft.FineTuneConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                              voxel_caps=CAPS, planes=NARROW, arch="MinkUNet14", remat=True)
    dcfg = td.DiscoverConfig(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                             unknown_label=17, voxel_caps=CAPS, sup_voxel_cap=1024,
                             mix_voxel_caps=CAPS, num_sup_scans=2, point_cap=1000,
                             planes=NARROW, arch="MinkUNet14", remat=True)
    for model in (tft.make_model(fcfg), td.make_model(dcfg)):
        assert model.encoder.block1.remat


def _heads_out(rng, n=300, k=17, ncc=3, ku=2):
    return {"logits_known": rng.standard_normal((n, k)).astype(np.float32),
            "logits_ncc": rng.standard_normal((n, ncc)).astype(np.float32),
            "logits_novel": rng.standard_normal((n, ku)).astype(np.float32)}


@pytest.mark.parametrize("name", ["assemble_dummy_logits", "assemble_dummy_logits_mean",
                                  "assemble_dummy_logits_sum", "assemble_novel_logits"])
def test_logit_assemblers_match_jax(name):
    out = _heads_out(np.random.default_rng(3))
    ref = getattr(jmk, name)({k: jnp.asarray(v) for k, v in out.items()})
    got = getattr(tmk, name)({k: torch.as_tensor(v) for k, v in out.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_dummy_logits_from_heads_matches_jax():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((200, 24)).astype(np.float32)
    f1 = {"kernel": rng.standard_normal((24, 17)).astype(np.float32),
          "bias": rng.standard_normal(17).astype(np.float32)}
    f2 = {"kernel": rng.standard_normal((24, 3)).astype(np.float32),
          "bias": rng.standard_normal(3).astype(np.float32)}
    ref = jmk.assemble_dummy_logits_from_heads(jnp.asarray(feats), f1, f2)
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa: E731
    got = tmk.assemble_dummy_logits_from_heads(torch.as_tensor(feats), t(f1), t(f2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_plane_variants_are_the_jax_packages():
    assert tmk.PLANE_VARIANTS == jmk.PLANE_VARIANTS
    assert tmk.ARCHS == jmk.ARCHS


def test_f32_conv_stays_f32_on_the_cpu():
    """On the CPU an f32 conv runs its plain version in f32 throughout: no
    bf16 rounding (that is the card's rule, `ops.fused_conv._kernel_operands`),
    and its gradients are f32."""
    from gcdlss_tpu_torch.ops import conv as plain
    from gcdlss_tpu_torch.ops.fused_conv import pool_conv, subm_conv

    rng = np.random.default_rng(5)
    nbr = torch.as_tensor(rng.integers(-1, 300, (300, 27)).astype(np.int32))
    x = torch.as_tensor(rng.standard_normal((300, 12)).astype(np.float32) / 3 + 1 / 3,
                        ).requires_grad_()
    w = torch.as_tensor(rng.standard_normal((27, 12, 5)).astype(np.float32)).requires_grad_()
    out = subm_conv(x, nbr, w)
    assert out.dtype == torch.float32
    assert torch.equal(out, plain.gather_conv(x.detach(), nbr, w.detach()))
    assert not torch.equal(out, plain.gather_conv(x.detach().bfloat16().float(), nbr,
                                                  w.detach().bfloat16().float()))
    out.square().sum().backward()
    assert x.grad.dtype == w.grad.dtype == torch.float32
    adj = torch.as_tensor(rng.integers(-1, 300, (300, 8)).astype(np.int32))
    fwd = torch.as_tensor(rng.integers(-1, 300, (300, 8)).astype(np.int32))
    assert pool_conv(x.detach(), fwd, adj, w.detach()[:8]).dtype == torch.float32
