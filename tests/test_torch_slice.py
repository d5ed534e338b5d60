"""PyTorch port vs JAX package: the Stage-1 slice end to end on the CPU.

MinkUNet14 with narrow planes at caps (2048, 1536, 1024, 512, 512). The JAX
package's initial weights are carried into the port (`utils.weights`); then
the forward logits, two `pretrain_train_step`s (loss, updated parameters,
batch statistics; the second step exercises the momentum buffer) and
`pretrain_eval_step`'s confusion matrix are compared. The port runs its plain
kernel versions here. Tolerances: f32, summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcdlss_tpu.data import (PrefetchLoader, SemanticKITTIDataset, build_label_mapping, collate_batch,
                             dataset_meta, split_table, write_synthetic_kitti)
from gcdlss_tpu.train import common as jcommon
from gcdlss_tpu.train import pretrain as jpt
from gcdlss_tpu.utils.import_torch import export_minkunet
from gcdlss_tpu_torch.train import common as tcommon
from gcdlss_tpu_torch.train import pretrain as tpt
from gcdlss_tpu_torch.utils.weights import (jax_to_state_dict, load_jax_params,
                                            load_reference_state_dict)

CAPS = (2048, 1536, 1024, 512, 512)
PLANES = (16, 16, 32, 32, 32, 16, 16, 16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one CPU thread while this module's tests run:
    the suite runs several workers at once, and each worker's default pool
    of one thread a core oversubscribes the cores. The pool's size is
    restored when the module's tests end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    write_synthetic_kitti(root, sequences=("00",), scans_per_seq=2, num_points=1200, seed=1)
    meta = dataset_meta("SemanticKITTI")
    unknown, _ = split_table("SemanticKITTI", 1)
    mapping, inv, unk = build_label_mapping(unknown, meta["learning_map_inv"].keys())
    kw = dict(num_labeled_classes=17, num_classes=19, unknown_label=unk, voxel_caps=CAPS,
              arch="MinkUNet14", planes=PLANES, use_scheduler=False, lr=0.05,
              steps_per_epoch=1)
    jcfg, tcfg = jpt.PretrainConfig(**kw), tpt.PretrainConfig(**kw)
    train_ds = SemanticKITTIDataset(root, "train", voxel_size=0.15, downsampling=1000,
                                    augment=True, label_mapping=mapping,
                                    unknown_labels=unknown, seed=0)
    val_ds = SemanticKITTIDataset(root, "valid", voxel_size=0.15, label_mapping=mapping,
                                  unknown_labels=unknown)
    batch = collate_batch([train_ds[0], train_ds[1]], CAPS[0])
    vbatch = collate_batch([val_ds[0], val_ds[1]], CAPS[0], point_cap=2048)
    jstate = jpt.create_pretrain_state(jax.random.PRNGKey(0), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, mapping=mapping, inv=inv, train_ds=train_ds,
                val_ds=val_ds, batch=batch, vbatch=vbatch,
                params=_np_tree(jstate.params), stats=_np_tree(jstate.batch_stats))


def _port_state(s):
    state = tpt.create_pretrain_state(0, s["tcfg"], device="cpu")
    load_jax_params(state.model, s["params"], s["stats"])
    return state


def _assert_state_close(jstate, tstate, rtol):
    ref = jax_to_state_dict(_np_tree(jstate.params), _np_tree(jstate.batch_stats))
    got = tstate.model.state_dict()
    assert set(ref) == set(got)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                   atol=rtol * max(np.abs(v).max(), 1e-6), err_msg=k)


def test_forward_logits_match_jax(setup):
    s = setup
    jmodel = jpt.make_model(s["jcfg"])

    @jax.jit
    def jfwd(params, stats, batch):
        plan, feats0, _, _ = jcommon.plan_and_gather(batch, CAPS)
        return jmodel.apply({"params": params, "batch_stats": stats}, plan, feats0,
                            train=False)["logits"]

    ref = jfwd(s["params"], s["stats"],
               jcommon.voxel_batch_to_device(s["batch"]["voxel"]))
    state = _port_state(s)
    state.model.eval()
    with torch.no_grad():
        plan, feats0, _, _ = tcommon.plan_and_gather(
            tcommon.voxel_batch_to_device(s["batch"]["voxel"], "cpu"), CAPS)
        got = state.model(plan, feats0)["logits"]
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (CAPS[0], 17)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_train_steps_and_eval_match_jax(setup):
    s = setup
    jb = jcommon.voxel_batch_to_device(s["batch"]["voxel"])
    tb = tcommon.voxel_batch_to_device(s["batch"]["voxel"], "cpu")
    # a fresh JAX state: its train step donates (deletes) the state it is given
    jstate = jpt.create_pretrain_state(jax.random.PRNGKey(0), s["jcfg"])
    tstate = _port_state(s)
    jlosses = []
    for step in range(2):
        jstate, jm = jpt.pretrain_train_step(jstate, jb, s["jcfg"])
        tstate, tm = tpt.pretrain_train_step(tstate, tb, s["tcfg"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert int(tm["plan_overflow"]) == int(jm["plan_overflow"])
        _assert_state_close(jstate, tstate, rtol=1e-4)
        jlosses.append(float(jm["loss"]))
    assert tstate.step == 2

    # the host loop on the same batch and weights: an epoch of one step, its
    # loss read at the epoch's end, against the JAX step's
    exp = tpt.ExpPretrain(s["tcfg"], s["mapping"], s["inv"], seed=0, device="cpu")
    load_jax_params(exp.state.model, s["params"], s["stats"])
    np.testing.assert_allclose(exp.train_epoch([s["batch"]]), jlosses[0], rtol=1e-5)

    lut = tcommon.inv_label_lut(s["inv"], 17)
    jconf, jloss = jpt.pretrain_eval_step(
        jstate, jcommon.voxel_batch_to_device(s["vbatch"]["voxel"]),
        jcommon.point_batch_to_device(s["vbatch"]["points"]), jnp.asarray(lut), s["jcfg"])
    tconf, tloss = tpt.pretrain_eval_step(
        tstate, tcommon.voxel_batch_to_device(s["vbatch"]["voxel"], "cpu"),
        tcommon.point_batch_to_device(s["vbatch"]["points"], "cpu"), torch.as_tensor(lut),
        s["tcfg"])
    assert int(tconf.sum()) > 0
    np.testing.assert_array_equal(tconf.numpy(), np.asarray(jconf))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_reference_state_dict_loader(setup):
    """A reference-layout dict (the JAX package's exporter, ME offset order)
    loads to the same tensors as the JAX trees do."""
    s = setup
    params, stats = s["params"], s["stats"]
    sd = export_minkunet(params, stats, prefix="model.")
    state = tpt.create_pretrain_state(1, s["tcfg"], device="cpu")
    missing = load_reference_state_dict(state.model, sd, prefix="model.")
    assert missing == []
    expect = jax_to_state_dict(params, stats)
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), expect[k], err_msg=k)


def test_exp_pretrain_epoch_and_validate(setup):
    """The host loop (`ExpPretrain`) through the repository's loader; its
    epoch reads the losses once, at its end, as the reference's does."""
    s = setup
    exp = tpt.ExpPretrain(s["tcfg"], s["mapping"], s["inv"], seed=0, device="cpu")
    loss = exp.train_epoch(PrefetchLoader(s["train_ds"], 2, CAPS[0], num_workers=1, seed=0))
    assert np.isfinite(loss) and len(exp.step_log) == 1
    assert set(exp.step_log[0]) == {"loss", "plan_overflow", "step_ms"}
    assert exp.step_log[0]["loss"] == loss and exp.step_log[0]["plan_overflow"] >= 0
    assert exp.step_log[0]["step_ms"] > 0
    vm = exp.validate(PrefetchLoader(s["val_ds"], 2, CAPS[0], point_cap=2048, shuffle=False,
                                     num_workers=1, drop_last=False))
    assert vm["conf"].shape == (19, 19) and vm["conf"].sum() > 0
    assert 0.0 <= vm["mIoU"] <= 1.0 and np.isfinite(vm["loss"])
