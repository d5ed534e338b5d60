"""PyTorch port vs JAX package: the library heads, wrappers, ORCA models, the
mmdet3d MinkUNet and the loss zoo, on the CPU.

The same numpy inputs and the JAX models' weights (perturbed from their
init, the batch-norm statistics moved off it) go through both packages; the
weights cross through `utils.weights.library_jax_to_state_dict` (and back).
The models run at MinkUNet14 with planes (4,) * 8 (the mmdet3d one at
widths 4 / 8) on one scan in a 512-row plan whose levels all fit; the JAX
models run eagerly (no compile). The port runs its plain kernel versions.

Tolerances (f32 on both sides, sums in another order): the models'
training-mode outputs and statistics, eval-mode outputs and eval-mode
gradients of a fixed cotangent 1e-5 of each tensor's largest magnitude
(gradients 1e-4: they sum over all rows; training-mode batch norm over
these few voxels makes gradients ill-conditioned, as `test_torch_cylinder.py`
found, so they are taken in eval mode); the heads and every loss of the zoo
and its gradient 1e-6 of the reference's largest magnitude.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcdlss_tpu import losses_zoo as jz
from gcdlss_tpu.models import backbone_mm as jmm
from gcdlss_tpu.models import heads as jh
from gcdlss_tpu.models import orca as jorca
from gcdlss_tpu.models import wrappers as jw
from gcdlss_tpu.ops.plan import build_unet_plan as jax_plan
from gcdlss_tpu_torch import losses_zoo as tz
from gcdlss_tpu_torch import models as tmodels
from gcdlss_tpu_torch.models import backbone_mm as tmm
from gcdlss_tpu_torch.models import heads as th
from gcdlss_tpu_torch.models import orca as torca
from gcdlss_tpu_torch.models import wrappers as tw
from gcdlss_tpu_torch.ops.plan import build_unet_plan as torch_plan
from gcdlss_tpu_torch.utils.weights import (jax_tree_to_state_dict, library_jax_to_state_dict,
                                            state_dict_to_jax_tree)

GOLDENS = Path(__file__).with_name("torch_library_goldens.npz")
CAP = 512
CAPS = (CAP, 512, 384, 256, 256)
OUT_TOL = 1e-5  # outputs and statistics: of the tensor's largest magnitude
GRAD_TOL = 1e-4  # the cotangent loss (relative) and the gradients
TINY = dict(arch="MinkUNet14", planes=(4,) * 8)
MM = dict(base_channels=4, encoder_channels=(4, 4, 8, 8), decoder_channels=(8, 8, 4, 4))

# name -> (JAX model, port model, output keys)
MODELS = {
    "MultiHeadMinkUnet": (
        lambda: jw.MultiHeadMinkUnet(5, 2, num_heads=2, overcluster_factor=3, **TINY),
        lambda: tw.MultiHeadMinkUnet(5, 2, num_heads=2, overcluster_factor=3, **TINY)),
    "MultiHeadMinkUnetFineTune": (lambda: jw.MultiHeadMinkUnetFineTune(5, 7, **TINY),
                                  lambda: tw.MultiHeadMinkUnetFineTune(5, 7, **TINY)),
    "MultiHeadSelfSupMinkUnet": (lambda: jw.MultiHeadSelfSupMinkUnet(16, simgcd=True, **TINY),
                                 lambda: tw.MultiHeadSelfSupMinkUnet(16, simgcd=True, **TINY)),
    "DualMinkUnet": (lambda: jw.DualMinkUnet(5, 2, **TINY), lambda: tw.DualMinkUnet(5, 2, **TINY)),
    "MinkUNetSegCosine": (lambda: jw.MinkUNetSegCosine(7, **TINY),
                          lambda: tw.MinkUNetSegCosine(7, **TINY)),
    "MinkUnetToy18": (lambda: jorca.MinkUnetToy18(5, **TINY),
                      lambda: torca.MinkUnetToy18(5, **TINY)),
    "MinkUnet34ORCA": (lambda: jorca.MinkUnet34ORCA(6, **TINY),
                       lambda: torca.MinkUnet34ORCA(6, **TINY)),
    "MultiHeadMinkUnet18": (
        lambda: jmm.MultiHeadMinkUnet18(5, 2, num_heads=2, overcluster_factor=3, **MM),
        lambda: tmm.MultiHeadMinkUnet18(5, 2, num_heads=2, overcluster_factor=3, **MM)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one CPU thread while this module's tests run
    (the suite runs several workers at once); restored when they end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max(initial=0)), 1e-6),
                               err_msg=what)


def _plan_inputs():
    """One scan's voxels in (b, x, y, z) order in a 512-row plan whose levels
    all fit, and 1-channel features (numpy)."""
    rng = np.random.default_rng(0)
    c = np.unique(rng.integers(-10, 10, (CAP, 3)).astype(np.int32), axis=0)
    c = c[np.lexsort(c.T[::-1])][: int(CAP * 0.9)]
    coords = np.zeros((CAP, 4), np.int32)
    coords[: len(c), 1:] = c
    valid = np.arange(CAP) < len(c)
    feats = (rng.uniform(0, 1, (CAP, 1)) * valid[:, None]).astype(np.float32)
    return coords, valid, feats


def _cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _weights(sd: dict, seed: int) -> dict:
    """numpy values for every tensor of a port state dict, drawn in key
    order: sparse kernels He-normal, dense ones LeCun-normal, cosine
    weights uniform(-1, 1), batch norms near the identity with running
    statistics away from their init."""
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(sd):
        shape = tuple(sd[key].shape)
        n = rng.standard_normal(shape)
        field = key.rsplit(".", 1)[1]
        if field == "kernel":
            v = n / np.sqrt(shape[0] * shape[2] / 2.0 if len(shape) == 3 else shape[0])
        elif field == "weight" and len(shape) == 2:
            v = rng.uniform(-1.0, 1.0, shape)
        elif field == "weight":
            v = 1.0 + 0.1 * n
        elif field == "running_var":
            v = 1.0 + 0.2 * np.abs(n)
        else:  # bias, running_mean
            v = 0.1 * n
        out[key] = v.astype(np.float32)
    return out


def _summary(a) -> np.ndarray:
    """max |a|, ||a|| and a's values at 32 positions fixed by its size (f32)."""
    a = np.asarray(a.detach() if hasattr(a, "detach") else a, np.float64).ravel()
    pos = np.sort(np.random.default_rng(a.size).choice(a.size, min(32, a.size), replace=False))
    return np.concatenate([[np.abs(a).max(initial=0), np.linalg.norm(a)], a[pos]]).astype(
        np.float32)


def _match(got, ref: np.ndarray, tol: float, what: str) -> None:
    s = _summary(got)
    assert s.shape == ref.shape, (what, s.shape, ref.shape)
    assert abs(s[1] - ref[1]) <= tol * max(ref[1], 1e-6), (what, s[1], ref[1])
    err = float(np.abs(s[2:] - ref[2:]).max(initial=0))
    assert err <= tol * max(ref[0], 1e-6), (what, err, ref[0])


def _tree_layout(params: dict, stats: dict) -> np.ndarray:
    """'params|path|shape' and 'batch_stats|...' for every leaf, sorted."""
    return np.array(sorted(
        f"{name}|{jax.tree_util.keystr(p)}|{tuple(np.shape(v))}"
        for name, tree in (("params", params), ("batch_stats", stats))
        for p, v in jax.tree_util.tree_leaves_with_path(tree)))


def _jax_goldens() -> dict:
    """Each model's JAX tree layout (from `init`), and from the port's
    weights carried into it: training-mode outputs and statistics,
    eval-mode outputs, the cotangent loss and its gradient (summaries)."""
    coords, valid, feats = _plan_inputs()
    jplan = jax_plan(jnp.asarray(coords), jnp.asarray(valid), CAPS, presorted=True)
    jf = jnp.asarray(feats)
    g = {}
    for i, (name, (make_j, make_t)) in enumerate(MODELS.items()):
        jm = make_j()
        init = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jplan, jf, train=False))
        params, stats = state_dict_to_jax_tree(_weights(make_t().state_dict(), i))
        g[f"{name}|tree"] = _tree_layout(init["params"], init["batch_stats"])
        assert np.array_equal(g[f"{name}|tree"], _tree_layout(params, stats)), name
        tr, upd = jm.apply({"params": params, "batch_stats": stats}, jplan, jf, train=True,
                           mutable=["batch_stats"])
        for k, v in tr.items():
            g[f"{name}|train|{k}"] = _summary(v)
        for k, v in jax_tree_to_state_dict(params, _np_tree(upd["batch_stats"])).items():
            if "running" in k:
                g[f"{name}|stats|{k}"] = _summary(v)
        keys = sorted(tr)

        def loss_fn(p):
            out = jm.apply({"params": p, "batch_stats": stats}, jplan, jf, train=False)
            return sum(jnp.sum(out[k] * _cotangent(out[k].shape, j))
                       for j, k in enumerate(keys)), out

        (loss, ev), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        g[f"{name}|loss"] = np.float32(loss)[None]
        for k, v in ev.items():
            g[f"{name}|eval|{k}"] = _summary(v)
        for k, v in jax_tree_to_state_dict(_np_tree(grads), {}).items():
            g[f"{name}|grad|{k}"] = _summary(v)
    return g


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDENS) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def tplan_feats():
    coords, valid, feats = _plan_inputs()
    plan = torch_plan(torch.as_tensor(coords), torch.as_tensor(valid), CAPS, presorted=True)
    assert all(int(lv.count) <= lv.valid.shape[0] for lv in plan.levels)
    return plan, torch.as_tensor(feats)


@pytest.mark.parametrize("name", list(MODELS))
def test_library_model_matches_jax(tplan_feats, goldens, name):
    """Training-mode outputs and updated statistics; eval-mode outputs, the
    loss sum(out[k] * cotangent_k) over every output and its gradient in
    every parameter, against the JAX model's (frozen goldens)."""
    plan, feats = tplan_feats
    i = list(MODELS).index(name)
    model = MODELS[name][1]()
    w = _weights(model.state_dict(), i)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in w.items()}, strict=True)
    model.train()
    with torch.no_grad():
        tr = model(plan, feats)
    assert {f"{name}|train|{k}" for k in tr} == {k for k in goldens
                                                 if k.startswith(f"{name}|train|")}
    for k, v in tr.items():
        _match(v, goldens[f"{name}|train|{k}"], OUT_TOL, f"train {k}")
    for k, v in model.state_dict().items():
        if "running" in k:
            _match(v, goldens[f"{name}|stats|{k}"], OUT_TOL, k)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in w.items()}, strict=True)
    model.eval()
    ev = model(plan, feats)
    keys = sorted(ev)
    for k in keys:
        _match(ev[k], goldens[f"{name}|eval|{k}"], OUT_TOL, f"eval {k}")
    loss = sum((ev[k] * torch.as_tensor(_cotangent(tuple(ev[k].shape), j))).sum()
               for j, k in enumerate(keys))
    np.testing.assert_allclose(loss.item(), goldens[f"{name}|loss"][0], rtol=GRAD_TOL)
    loss.backward()
    names = {k.split("|", 2)[2] for k in goldens if k.startswith(f"{name}|grad|")}
    assert names == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        _match(p.grad, goldens[f"{name}|grad|{k}"], GRAD_TOL, f"grad {k}")


# ---- the heads in float64, with a bound on any f32 evaluation's distance

U32 = 2.0 ** -24  # the unit roundoff of f32 (half its eps)
LAMBDA = 8.0


def _gamma(n: int) -> float:
    """A bound on the relative rounding error of a sum of n terms: the worst
    case n u / (1 - n u), or, where smaller (n above 64), Higham and Mary's
    probabilistic exp(lambda sqrt(n) u + n u^2 / (1 - u)) - 1 (SIAM J. Sci.
    Comput. 41(5), 2019), which fails with probability under
    2 n exp(-lambda^2 (1 - u)^2 / 2) a dot product for independent
    roundings: under 1e-6 over all of this test's at lambda 8."""
    return float(min(n * U32 / (1 - n * U32),
                     np.expm1(LAMBDA * np.sqrt(n) * U32 + n * U32 ** 2 / (1 - U32))))


class _B:
    """A value in float64 and a bound on how far an f32 evaluation of the
    same operations lies from it: a first-order running error analysis
    (Higham, *Accuracy and Stability of Numerical Algorithms*, 2nd ed.,
    §3.1-3.5). Inputs, weights and cotangents are exact f32; a sum or dot
    product of n terms, in any order, adds gamma_n times the sum of its
    terms' magnitudes; any other operation adds U32 of its result. So the
    bound of a dot product that cancels is large beside its value: at a row
    whose embedding h is small against |x|·|W|, its normalisation carries
    gamma_n |x|·|W| / ||h|| into every output of the row."""

    def __init__(self, v, e=None):
        self.v = np.asarray(v, np.float64)
        self.e = np.zeros_like(self.v) if e is None else e

    @property
    def T(self):
        return _B(self.v.T, self.e.T)


def _round(v, e):
    return _B(v, e + U32 * np.abs(v))


def _mm(a, b):
    av, bv = np.abs(a.v), np.abs(b.v)
    return _B(a.v @ b.v, a.e @ bv + av @ b.e + a.e @ b.e + _gamma(a.v.shape[-1]) * (av @ bv))


def _add(a, b):
    return _round(a.v + b.v, a.e + b.e)


def _mul(a, b):
    return _round(a.v * b.v, a.e * np.abs(b.v) + np.abs(a.v) * b.e + a.e * b.e)


def _scale(a, c: float):
    return _round(c * a.v, abs(c) * a.e)


def _sum(a, axis: int):
    n = a.v.shape[axis]
    return _B(a.v.sum(axis, keepdims=True),
              a.e.sum(axis, keepdims=True) + _gamma(n) * np.abs(a.v).sum(axis, keepdims=True))


def _div(a, b):
    v = a.v / b.v
    room = np.abs(b.v) - b.e  # b's least magnitude
    return _round(v, np.where(room > 0, (a.e + np.abs(v) * b.e) / np.where(room > 0, room, 1),
                              np.inf))


def _relu(a):
    return _B(np.maximum(a.v, 0.0), a.e)


def _relu_grad(g, a):
    """g where a > 0; where |a| is within its bound the mask may flip."""
    live = a.v > 0
    return _B(g.v * live, g.e * live + np.abs(g.v) * (np.abs(a.v) < a.e))


def _norm(a, axis: int):
    """max(||a||_2, 1e-12) along `axis`: |sqrt(s') - sqrt(s)| is at most
    sqrt(|s' - s|) and |s' - s| / sqrt(s); the floor moves no error."""
    s = _sum(_mul(a, a), axis)
    r = np.sqrt(s.v)
    e = np.minimum(np.sqrt(s.e), np.where(r > 0, s.e / np.where(r > 0, r, 1), np.inf))
    return _B(np.maximum(r, 1e-12), e + U32 * r)


def _normalize(a, axis: int = -1):
    r = _norm(a, axis)
    return _div(a, r), r


def _normalize_grad(a, r, g, axis: int = -1):
    """The gradient in `a` of sum(g * a / r), r = `_norm(a)`: through the
    quotient, then through the norm where it is above its floor."""
    d = _div(g, r)
    dr = _div(_sum(_mul(g, a), axis), _mul(r, r))
    through = _mul(dr, _div(a, r))
    live = r.v > 1e-12
    return _add(d, _B(-through.v * live, through.e * live))


def _prototypes(p, pre, x):
    k = p[pre + "prototypes.kernel"]
    return _mm(x, k), lambda g: (_mm(g, k.T), {pre + "prototypes.kernel": _mm(x.T, g)})


def _cosine(p, pre, x):
    w = p[pre + "weight"]
    xn, rx = _normalize(x)
    wn, rw = _normalize(w)

    def back(g):
        g = _scale(g, 10.0)
        return (_normalize_grad(x, rx, _mm(g, wn)),
                {pre + "weight": _normalize_grad(w, rw, _mm(g.T, xn))})
    return _scale(_mm(xn, wn.T), 10.0), back


def _projection(p, pre, x):
    acts, pre_acts = [x], []
    for i in range(3):
        z = _add(_mm(acts[-1], p[f"fc{i}.kernel"]), p[f"fc{i}.bias"])
        pre_acts.append(z)
        acts.append(_relu(z) if i < 2 else z)

    def back(g):
        grads = {}
        for i in (2, 1, 0):
            if i < 2:
                g = _relu_grad(g, pre_acts[i])
            grads[f"fc{i}.kernel"] = _mm(acts[i].T, g)
            grads[f"fc{i}.bias"] = _sum(g, 0)
            g = _mm(g, p[f"fc{i}.kernel"].T)
        return g, grads
    return acts[-1], back


def _multi(unit, n):
    def head(p, pre, x):
        parts = [unit(p, f"head{h}.", x) for h in range(n)]

        def back(g):
            dx, grads = None, {}
            for h, (_, b) in enumerate(parts):
                dxh, gh = b(_B(g.v[h], g.e[h]))
                dx = dxh if dx is None else _add(dx, dxh)
                grads.update(gh)
            return dx, grads
        return _B(np.stack([o.v for o, _ in parts]), np.stack([o.e for o, _ in parts])), back
    return head


def _equiangular(p, pre, x):
    k = p["embedding.kernel"]
    z = _mm(x, k)
    h = _relu(z)
    hn, rh = _normalize(h)
    mn, _ = _normalize(p["matrix"], 0)

    def back(g):
        dz = _relu_grad(_normalize_grad(h, rh, _mm(g, mn.T)), z)
        return _mm(dz, k.T), {"embedding.kernel": _mm(x.T, dz)}
    return _mm(hn, mn), back


def _held(what, port, jx, ref):
    """The port and JAX each within the oracle's bound of its value; the port
    and JAX within 1e-6 of JAX's largest magnitude wherever the bound is
    smaller than that, elsewhere within twice the bound."""
    port = np.asarray(port.detach() if hasattr(port, "detach") else port, np.float64)
    jx = np.asarray(jx, np.float64).reshape(port.shape)
    v, b = ref.v.reshape(port.shape), ref.e.reshape(port.shape)
    for side, got in (("port", port), ("JAX", jx)):
        out = np.argwhere(~(np.abs(got - v) <= b))
        assert not out.size, (
            f"{what}: the {side} beyond the f64 oracle's bound at {out[:8].tolist()}"
            f" ({out.shape[0]} places); first: {side} {float(got[tuple(out[0])])!r},"
            f" oracle {float(v[tuple(out[0])])!r}, bound {float(b[tuple(out[0])])!r}")
    floor = 1e-6 * max(float(np.abs(jx).max(initial=0)), 1e-6)
    tol = np.where(b < floor, floor, 2 * b)
    out = np.argwhere(~(np.abs(port - jx) <= tol))
    assert not out.size, (f"{what}: port against JAX at {out[:8].tolist()} ({out.shape[0]} places);"
                          f" first: port {float(port[tuple(out[0])])!r},"
                          f" JAX {float(jx[tuple(out[0])])!r}, tolerance {float(tol[tuple(out[0])])!r}")


def test_heads_match_jax():
    """Every head of `models.heads` on the same rows and weights: outputs
    (a zero row among the rows: the norms' floor) and the gradients of a
    cotangent in the inputs and parameters (on nonzero rows: at a zero row
    the JAX norm's gradient is NaN, torch's 0), each side held to the heads
    evaluated in float64 from the same weights within the oracle's bound
    (`_B`), and to each other; the equiangular matrix bit for bit; the
    package exports the JAX package's names."""
    rng = np.random.default_rng(2)
    xg = rng.standard_normal((40, 12)).astype(np.float32)
    x0 = xg.copy()
    x0[3] = 0.0
    cases = [
        (jh.Prototypes(7), lambda: th.Prototypes(12, 7), _prototypes),
        (jh.CosinePrototypes(7), lambda: th.CosinePrototypes(12, 7), _cosine),
        (jh.ProjectionHead(), lambda: th.ProjectionHead(12), _projection),
        (jh.MultiHead(5, 3), lambda: th.MultiHead(12, 5, 3), _multi(_prototypes, 3)),
        (jh.MultiHead(5, 2, cosine=True), lambda: th.MultiHead(12, 5, 2, cosine=True),
         _multi(_cosine, 2)),
        (jh.EquiangularPrototypes(5, seed=3), lambda: th.EquiangularPrototypes(12, 5, seed=3),
         _equiangular),
    ]
    for i, (jhead, make, oracle) in enumerate(cases):
        params = _np_tree(jhead.init(jax.random.PRNGKey(i), jnp.asarray(xg))["params"])
        head = make()
        load = library_jax_to_state_dict({"h": params}, {})
        head.load_state_dict({k[2:]: torch.tensor(np.asarray(v)) for k, v in load.items()})
        p64 = {k: _B(v.detach().numpy()) for k, v in head.state_dict(keep_vars=True).items()}
        p64.update({k: _B(v.numpy()) for k, v in head.named_buffers()})
        with torch.no_grad():
            _held(f"head {i} zero row", head(torch.as_tensor(x0)),
                  jhead.apply({"params": params}, jnp.asarray(x0)), oracle(p64, "", _B(x0))[0])
        cot = _cotangent(np.shape(jhead.apply({"params": params}, jnp.asarray(xg))), i)
        _, (jgp, jgx) = jax.value_and_grad(
            lambda p, xx: jnp.sum(jhead.apply({"params": p}, xx) * cot), argnums=(0, 1))(
                params, jnp.asarray(xg))
        ref, back = oracle(p64, "", _B(xg))
        ref_dx, ref_grads = back(_B(cot))
        xt = torch.as_tensor(xg).requires_grad_()
        out = head(xt)
        _held(f"head {i}", out, jhead.apply({"params": params}, jnp.asarray(xg)), ref)
        (out * torch.as_tensor(cot)).sum().backward()
        _held(f"head {i} dx", xt.grad, jgx, ref_dx)
        jgrad = library_jax_to_state_dict({"h": _np_tree(jgp)}, {})
        assert set(ref_grads) == {k for k, _ in head.named_parameters()}
        for k, p in head.named_parameters():
            _held(f"head {i} d{k}", p.grad, jgrad[f"h.{k}"], ref_grads[k])
    np.testing.assert_array_equal(th._equiangular_matrix(48, 10, 4),
                                  jh._equiangular_matrix(48, 10, 4))
    from gcdlss_tpu import models as jmodels
    assert set(tmodels.__all__) == set(jmodels.__all__)
    for name in ("MinkUnetToy18", "MinkUnet34ORCA", "MinkUNetBackboneMM", "MultiHeadMinkUnet18"):
        assert hasattr(tmodels, name), name


def test_weights_bridge_round_trip(goldens):
    """Port state dict -> JAX trees lands on the JAX package's tree layout
    (names and shapes, from its `init`) for every library model, and back
    -> port is the identity, as is JAX -> port -> JAX; the flax names land
    where the port keeps them."""
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    for i, (name, (_, make_t)) in enumerate(MODELS.items()):
        sd = _weights(make_t().state_dict(), i)
        params, stats = state_dict_to_jax_tree(sd)
        np.testing.assert_array_equal(_tree_layout(params, stats), goldens[f"{name}|tree"])
        back = jax_tree_to_state_dict(params, stats)
        assert set(back) == set(sd), name
        for k, v in sd.items():
            np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=f"{name} {k}")
        for got, want in zip(state_dict_to_jax_tree(back), (params, stats)):
            got, want = flat(got), flat(want)
            assert set(got) == set(want), name
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=f"{name} {k}")
    sd = tmm.MultiHeadMinkUnet18(5, 2, num_heads=2).state_dict()
    assert sd["backbone.conv_input0.kernel"].shape == (27, 1, 32)
    assert sd["backbone.dec0_blocks.0.downsample.0.kernel"].shape == (384, 256)
    assert sd["backbone.dec3_blocks.0.downsample.0.kernel"].shape == (128, 96)
    assert sd["head_unlab.head1.prototypes.kernel"].shape == (96, 2)
    assert "metric_learner.fc2.bias" in tw.MultiHeadSelfSupMinkUnet().state_dict()
    assert "encoder_b.block8.0.conv2.kernel" in tw.DualMinkUnet(5, 2).state_dict()


@pytest.mark.slow
def test_library_goldens_are_the_jax_package(goldens):
    """The frozen goldens, rebuilt from the JAX package (minutes of eager
    JAX on the CPU)."""
    fresh = _jax_goldens()
    assert set(fresh) == set(goldens)
    for k, v in fresh.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(v, goldens[k], rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(v, goldens[k], err_msg=k)


def _both(fn_j, fn_t, arrays: dict, grad_of: tuple, what: str, **kw):
    """fn on both packages: the value within 1e-6 relative and its gradient
    in each of `grad_of` within 1e-6 of the reference's largest magnitude."""
    names = list(arrays)
    jargs = {k: jnp.asarray(v) for k, v in arrays.items()}

    kw_j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    kw_t = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}

    def jloss(*diff):
        a = dict(jargs, **dict(zip(grad_of, diff)))
        return fn_j(**a, **kw_j)

    ref, jg = jax.value_and_grad(jloss, argnums=tuple(range(len(grad_of))))(
        *(jargs[k] for k in grad_of))
    targs = {k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()}
    for k in grad_of:
        targs[k].requires_grad_()
    got = fn_t(**targs, **kw_t)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-7, err_msg=what)
    got.backward()
    for k, g in zip(grad_of, jg):
        _close(targs[k].grad, g, 1e-6, f"{what} d{k}")
    assert set(names) >= set(grad_of)


def _rows(rng, n, c, v=None):
    shape = (n, c) if v is None else (n, v, c)
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("family", ["prototype", "supcon", "metric", "distill"])
def test_losses_zoo_match_jax(family):
    """Every function of `losses_zoo` and its gradient, at the option
    values that change its arithmetic."""
    rng = np.random.default_rng({"prototype": 3, "supcon": 4, "metric": 5, "distill": 6}[family])
    n = 48
    labels = rng.integers(-1, 5, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    if family == "prototype":
        f = rng.standard_normal((n, 16)).astype(np.float32)
        p = rng.standard_normal((5, 16)).astype(np.float32)
        for norm in (True, False):
            for vd in (None, valid):
                _both(jz.hybrid_distance_cross_entropy, tz.hybrid_distance_cross_entropy,
                      dict(features=f, prototypes=p, labels=labels), ("features", "prototypes"),
                      f"hybrid {norm}", valid=vd, normalized=norm)
                _both(jz.attractive_loss, tz.attractive_loss,
                      dict(features=f, prototypes=p, labels=labels), ("features", "prototypes"),
                      "attractive", valid=vd)
        _both(jz.prototype_regularization, tz.prototype_regularization, dict(prototypes=p),
              ("prototypes",), "regularization")
        _both(jz.adv_loss, tz.adv_loss, dict(synthetic_features=f, prototypes=p),
              ("synthetic_features", "prototypes"), "adv")
        prob = rng.dirichlet(np.ones(6), (2, n)).astype(np.float32)
        simi = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
        _both(jz.pairwise_bce, tz.pairwise_bce, dict(prob1=prob[0], prob2=prob[1], simi=simi),
              ("prob1", "prob2"), "pairwise_bce")
    elif family == "supcon":
        for v in (1, 2):
            feats = _rows(rng, n, 8, v)
            _both(jz.supcon_loss, tz.supcon_loss, dict(features=feats, labels=labels),
                  ("features",), f"supcon labels v{v}", valid=valid)
            _both(jz.supcon_loss, tz.supcon_loss, dict(features=feats), ("features",),
                  f"supcon eye v{v}")
            m = (rng.random((n, n)) < 0.2).astype(np.float32)
            _both(jz.supcon_loss, tz.supcon_loss, dict(features=feats, mask=m), ("features",),
                  f"supcon mask v{v}", temperature=0.1, base_temperature=0.05)
            aux = _rows(rng, 20, 8)
            aux_valid = rng.random(20) < 0.7
            _both(jz.supcon_loss_with_auxiliary, tz.supcon_loss_with_auxiliary,
                  dict(features=feats, labels=labels, aux_features=aux),
                  ("features", "aux_features"), f"supcon aux v{v}", valid=valid,
                  aux_valid=aux_valid)
    elif family == "metric":
        ignore = rng.integers(0, 3, n).astype(np.int32)
        for metric in tz.METRICS:
            for v in (1, 2):
                feats = _rows(rng, n, 8, v)
                for ig in (None, ignore):
                    _both(jz.metric_supcon_loss, tz.metric_supcon_loss,
                          dict(features=feats, labels=labels), ("features",),
                          f"{metric} v{v}", ignore=ig, valid=valid, metric=metric)
                j = jz.metric_supcon_loss(jnp.asarray(feats), jnp.asarray(labels),
                                          metric=metric, reduction=False)
                t = tz.metric_supcon_loss(torch.as_tensor(feats), torch.as_tensor(labels),
                                          metric=metric, reduction=False)
                assert tuple(t.shape) == (v, n)
                _close(t, j, 1e-6, f"{metric} v{v} per anchor")
        with pytest.raises(NotImplementedError):
            tz.metric_supcon_loss(torch.as_tensor(_rows(rng, 4, 8, 1)), metric="cos")
    else:
        for ncrops in (2, 3):
            s = rng.standard_normal((ncrops * 16, 10)).astype(np.float32)
            t = rng.standard_normal((ncrops * 16, 10)).astype(np.float32)
            for epoch in (0, 3, 30):  # warm-up start, middle, past its end (clipped)
                # the teacher's softmax is held constant: no gradient reaches it
                _both(jz.distill_loss, tz.distill_loss, dict(student_out=s, teacher_out=t),
                      ("student_out",), f"distill {ncrops} {epoch}",
                      epoch=epoch, warmup_teacher_temp_epochs=10, nepochs=50, ncrops=ncrops)


if __name__ == "__main__":
    # python tests/test_torch_library.py: write the goldens
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDENS, **_jax_goldens())
    print(GOLDENS, file=sys.stderr)
