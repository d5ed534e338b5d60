"""PyTorch port vs JAX package: schedule, loss, optimizer, capacities and
evaluation metrics. Inputs made from a seed with numpy; f32 tolerances."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gcdlss_tpu import losses as jlosses
from gcdlss_tpu.eval import metrics as jmetrics
from gcdlss_tpu.train import common as jcommon
from gcdlss_tpu.train import schedule as jschedule
from gcdlss_tpu_torch import losses as tlosses
from gcdlss_tpu_torch.eval import metrics as tmetrics
from gcdlss_tpu_torch.train import common as tcommon
from gcdlss_tpu_torch.train import schedule as tschedule
from gcdlss_tpu_torch.train.pretrain import PretrainConfig


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


@pytest.mark.parametrize("use_scheduler", [True, False])
def test_lr_schedule_matches_jax(use_scheduler):
    cfg = PretrainConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                         voxel_caps=(256,) * 5, lr=0.02, warmup_epochs=4, min_lr=1e-5,
                         epochs=20, steps_per_epoch=3, use_scheduler=use_scheduler)
    js, ts = jschedule.make_lr_schedule(cfg), tschedule.make_lr_schedule(cfg)
    for step in range(0, 70, 2):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, atol=1e-9)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((200, 17)).astype(np.float32) * 3
    labels = rng.integers(-1, 17, 200).astype(np.int32)
    valid = rng.random(200) < 0.8
    ref = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid))
    got = tlosses.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                                torch.as_tensor(valid))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_sgd_matches_optax_chain():
    """torch SGD == optax add_decayed_weights -> trace -> scale_by_lr, over
    three steps with a changing rate."""
    rng = np.random.default_rng(1)
    cfg = PretrainConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                         voxel_caps=(256,) * 5, momentum=0.9, weight_decay=1e-3)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) for _ in range(3)]
    lrs = [0.1, 0.05, 0.02]

    tx = jcommon.make_sgd(cfg, lambda count: jnp.asarray(lrs)[count])
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)

    tp = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = tcommon.make_sgd(cfg, [tp])
    for g, lr in zip(grads, lrs):
        for group in opt.param_groups:
            group["lr"] = lr
        tp.grad = torch.as_tensor(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n0", [2048, 138_240, 276_480])
def test_default_caps_match_jax(n0):
    assert tcommon.default_caps(n0) == jcommon.default_caps(n0)


def test_inv_label_lut_matches_jax():
    inv = {0: 10, 1: 11, 5: 30, 16: 72, 20: 99}
    np.testing.assert_array_equal(tcommon.inv_label_lut(inv, 17, extra={17: 4}),
                                  jcommon.inv_label_lut(inv, 17, extra={17: 4}))


def test_confusion_and_hungarian_match_jax():
    rng = np.random.default_rng(2)
    preds = rng.integers(-1, 19, 3000).astype(np.int32)
    labels = np.where(rng.random(3000) < 0.6, preds, rng.integers(-1, 19, 3000)).astype(np.int32)
    valid = rng.random(3000) < 0.9
    jconf = np.asarray(jmetrics.confusion_update(jnp.asarray(preds), jnp.asarray(labels), 19,
                                                 jnp.asarray(valid)))
    tconf = tmetrics.confusion_update(torch.as_tensor(preds), torch.as_tensor(labels), 19,
                                      torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(tconf, jconf)
    jiou, jinc = jmetrics.strict_hungarian_iou(jconf, 19)
    tiou, tinc = tmetrics.strict_hungarian_iou(tconf, 19)
    np.testing.assert_array_equal(tinc, jinc)
    np.testing.assert_allclose(tiou, jiou, rtol=0, atol=0)
    np.testing.assert_allclose(tmetrics.get_iou(tconf, [1, 3]), jmetrics.get_iou(jconf, [1, 3]))
