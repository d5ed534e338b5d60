"""PyTorch port vs JAX package: sparse convolutions (forward, dX, dW) and
batch norm.

The port runs its plain versions here, reached through its autograd Functions
(the kernel wrappers take the plain version for CPU tensors). The JAX side runs
the Pallas kernels in interpret mode and the XLA gather path. Inputs are f32
arrays holding bf16-representable values: the JAX kernels round to bf16, so
their products are then exact and only the f32 summation order differs.
Tolerance: 1e-4 of the reference's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcdlss_tpu.models import layers as jlayers
from gcdlss_tpu.ops import conv as jconv
from gcdlss_tpu.ops import fused_conv as jfused
from gcdlss_tpu.ops.plan import build_unet_plan
from gcdlss_tpu_torch.models.layers import SparseBatchNorm
from gcdlss_tpu_torch.ops import conv as tconv
from gcdlss_tpu_torch.ops import fused_conv as tfused

CAPS = (4096, 2048, 1024, 512, 256)
TOL = 1e-4


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


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def plan():
    rng = np.random.default_rng(7)
    pts = rng.integers(-25, 25, size=(5200, 3)).astype(np.int32)
    b = rng.integers(0, 2, size=(5200, 1)).astype(np.int32)
    c = np.unique(np.concatenate([b, pts], 1), axis=0)[: int(CAPS[0] * 0.9)]
    coords = np.zeros((CAPS[0], 4), np.int32)
    coords[: len(c)] = c
    valid = np.zeros(CAPS[0], bool)
    valid[: len(c)] = True
    p = jax.jit(build_unet_plan, static_argnames=("caps", "presorted"))(
        jnp.asarray(coords), jnp.asarray(valid), caps=CAPS, presorted=True)
    return jax.tree_util.tree_map(np.asarray, p)


def _inputs(rng, valid, ci, co, k, n_out):
    x = _bf16(rng.standard_normal((valid.shape[0], ci)) * valid[:, None])
    w = _bf16(rng.standard_normal((k, ci, co)) * (2.0 / (k * ci)) ** 0.5)
    cot = _bf16(rng.standard_normal((n_out, co)))
    return x, w, cot


def _port_grads(fn, x, w, cot):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = fn(xt, wt)
    (out * torch.tensor(cot)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


def _jax_grads(fn, x, w, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(cot, out.dtype))
    return np.asarray(out, np.float32), np.asarray(gx), np.asarray(gw)


def _close(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL * max(np.abs(r).max(), 1e-6))


@pytest.mark.parametrize("ci,co", [(32, 48), (192, 32), (1, 16)])
def test_subm_conv_matches_jax(plan, ci, co):
    """k=3 books (level 1) against the XLA gather path and, at one width, the
    Pallas kernel; the k=5 one-channel stem (level 0) against the XLA path."""
    rng = np.random.default_rng(ci)
    stem = ci == 1
    lvl = plan.levels[0 if stem else 1]
    nbr = plan.stem_nbr if stem else lvl.nbr3
    x, w, cot = _inputs(rng, lvl.valid, ci, co, nbr.shape[1], nbr.shape[0])
    nbr_t = torch.tensor(nbr)
    got = _port_grads(lambda a, b: tfused.subm_conv(a, nbr_t, b), x, w, cot)
    ref = _jax_grads(lambda a, b: jconv.gather_conv(a, jnp.asarray(nbr), b,
                                                    symmetric_adjoint=True), x, w, cot)
    _close(got, ref)
    if ci == 32:
        ref_k = _jax_grads(lambda a, b: jfused.fused_subm_conv(a, jnp.asarray(nbr), b,
                                                               interpret=True), x, w, cot)
        _close(got, ref_k)


@pytest.mark.parametrize("direction", ["down", "up"])
def test_pool_conv_matches_jax(plan, direction):
    """k=2 s=2 pool convs over children/upmap against the Pallas kernel
    (transposed layout, interpret mode) and the XLA segment-sum oracles."""
    rng = np.random.default_rng(11)
    pool = plan.pools[0]
    capc = CAPS[1]
    down = direction == "down"
    ci, co = (32, 64) if down else (64, 32)
    src = plan.levels[0 if down else 1]
    fwd, adj = (pool.children, pool.upmap) if down else (pool.upmap, pool.children)
    x, w, cot = _inputs(rng, src.valid, ci, co, 8, fwd.shape[0])
    f_t, a_t = torch.tensor(fwd), torch.tensor(adj)
    got = _port_grads(lambda a, b: tfused.pool_conv(a, f_t, a_t, b), x, w, cot)
    ref_k = _jax_grads(lambda a, b: jfused.fused_pool_conv_T(
        a.T, jnp.asarray(fwd), jnp.asarray(adj), b, interpret=True).T, x, w, cot)
    _close(got, ref_k)
    if down:
        ref = _jax_grads(lambda a, b: jconv.down_conv(
            a, jnp.asarray(pool.parent), jnp.asarray(pool.dcode), b, capc), x, w, cot)
        oracle = tconv.down_conv(torch.as_tensor(x), torch.tensor(pool.parent),
                                 torch.tensor(pool.dcode), torch.as_tensor(w), capc)
    else:
        ref = _jax_grads(lambda a, b: jconv.up_conv(
            a, jnp.asarray(pool.parent), jnp.asarray(pool.dcode), b), x, w, cot)
        oracle = tconv.up_conv(torch.as_tensor(x), torch.tensor(pool.parent),
                               torch.tensor(pool.dcode), torch.as_tensor(w))
    _close(got, ref)
    _close([oracle.numpy()], ref[:1])


def test_kernel_wrappers_take_plain_version_on_cpu(plan):
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing."""
    rng = np.random.default_rng(3)
    lvl = plan.levels[1]
    x, w, cot = _inputs(rng, lvl.valid, 16, 8, 27, CAPS[1])
    xt, wt, gt = map(torch.as_tensor, (x, w, cot))
    nbr = torch.tensor(lvl.nbr3)
    adj = nbr.flip(1).contiguous()
    counts = (tfused.gather_gemm.launches, tfused.gather_gemm_backward.launches)
    torch.testing.assert_close(tfused.gather_gemm(xt, nbr, wt), tconv.gather_conv(xt, nbr, wt),
                               rtol=0, atol=0)
    for a, b in zip(tfused.gather_gemm_backward(xt, gt, adj, wt),
                    tconv.gather_conv_backward(xt, gt, adj, wt)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (tfused.gather_gemm.launches, tfused.gather_gemm_backward.launches) == counts


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax(train):
    """Masked BN: output and, in training, the running-statistics update;
    then the norm with the residual add and the ReLU folded in (its plain
    version on the CPU), output, gradients and statistics bit for bit the
    eager composition it replaces."""
    rng = np.random.default_rng(5)
    n, c = 300, 24
    x = rng.standard_normal((n, c)).astype(np.float32) * 3 + 1
    valid = rng.random(n) < 0.8
    x *= valid[:, None]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean0 = rng.standard_normal(c).astype(np.float32)
    var0 = rng.uniform(0.5, 2, c).astype(np.float32)

    jbn = jlayers.SparseBatchNorm()
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    jout, mut = jbn.apply(variables, jnp.asarray(x), jnp.asarray(valid), not train,
                          mutable=["batch_stats"])

    tbn = SparseBatchNorm(c)
    tbn.load_state_dict({"weight": torch.as_tensor(scale), "bias": torch.as_tensor(bias),
                         "running_mean": torch.as_tensor(mean0),
                         "running_var": torch.as_tensor(var0)})
    tbn.train(train)
    with torch.no_grad():
        tout = tbn(torch.as_tensor(x), torch.as_tensor(valid))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), rtol=1e-6, atol=1e-6)
    assert np.all(tout.numpy()[~valid] == 0)

    state = {"weight": torch.as_tensor(scale), "bias": torch.as_tensor(bias),
             "running_mean": torch.as_tensor(mean0), "running_var": torch.as_tensor(var0)}
    residual = torch.as_tensor(rng.standard_normal((n, c)).astype(np.float32) * valid[:, None])
    gz = torch.as_tensor(rng.standard_normal((n, c)).astype(np.float32))
    for res, act in ((None, "relu"), (residual, "none"), (residual, "relu")):
        runs = []
        for fused in (True, False):
            bn = SparseBatchNorm(c)
            bn.load_state_dict(state)
            bn.train(train)
            xs = torch.as_tensor(x).requires_grad_()
            rs = None if res is None else res.clone().requires_grad_()
            if fused:
                out = bn(xs, torch.as_tensor(valid), rs, act)
            else:  # the blocks' eager chain: norm, + residual, relu, mask
                out = bn(xs, torch.as_tensor(valid))
                if rs is not None:
                    out = out + rs
                if act == "relu":
                    out = torch.relu(out)
                if rs is not None:
                    out = out * torch.as_tensor(valid)[:, None]
            out.backward(gz)
            runs.append([out.detach(), xs.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
                         bn.running_var] + ([] if rs is None else [rs.grad]))
        for got, want in zip(*runs):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert np.all(runs[0][0].numpy()[~valid] == 0)
