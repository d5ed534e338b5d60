"""The sparse-conv wrappers' CPU side after their kernels' redesign.

(a) The port's entry points default to the card: without a device
    argument and without a CUDA device they raise; with `device="cpu"` they run.
(b) The plain statements of what the CUDA kernels visit: K1 multiplies only
    the (16-row strip, offset) pairs of `strips_kept_plain`, dW only the pairs
    of `compact_pairs_plain`. Visiting exactly those reproduces `gather_conv`
    and `gather_conv_backward`. Inputs are small integers, so every f32 sum is
    exact and the comparison is equality, whatever the order of the sums.
(c) `out_dtype`, `reverse` and `need_dx` of the wrappers, and `subm_conv` /
    `pool_conv` against the JAX package's `gather_conv` and its gradients
    where the input needs no gradient (tolerance 1e-4 of the reference's scale:
    bf16-representable inputs, f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcdlss_tpu.ops import conv as jconv
from gcdlss_tpu_torch.ops import conv as tconv
from gcdlss_tpu_torch.ops import fused_conv as tfused
from gcdlss_tpu_torch.train import discover as td
from gcdlss_tpu_torch.train import finetune as tft
from gcdlss_tpu_torch.train import pretrain as tpt
from gcdlss_tpu_torch.train.common import resolve_device
from gcdlss_tpu_torch.train.modules import ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive

CAPS = (256, 256, 256, 256, 256)
PLANES = (8, 8, 8, 8, 8, 8, 8, 8)
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


def _pretrain_cfg():
    return tpt.PretrainConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                              voxel_caps=CAPS, arch="MinkUNet14", planes=PLANES)


def _discover_cfg():
    return td.DiscoverConfig(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                             unknown_label=17, voxel_caps=CAPS, sup_voxel_cap=128,
                             mix_voxel_caps=CAPS, num_sup_scans=1, point_cap=256,
                             arch="MinkUNet14", planes=PLANES,
                             queue_slots=2, queue_per_slot=16)


def _finetune_cfg():
    return tft.FineTuneConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                              voxel_caps=CAPS, arch="MinkUNet14", planes=PLANES)


MAPPING = {i: i for i in range(19)}
ENTRY_POINTS = {
    "create_pretrain_state": lambda **kw: tpt.create_pretrain_state(0, _pretrain_cfg(), **kw),
    "ExpPretrain": lambda **kw: tpt.ExpPretrain(_pretrain_cfg(), MAPPING, MAPPING, seed=0, **kw),
    "create_discover_state": lambda **kw: td.create_discover_state(0, _discover_cfg(), **kw),
    "ExpMergeDiscover": lambda **kw: ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive(
        _discover_cfg(), MAPPING, MAPPING, seed=0, **kw),
    "create_finetune_state": lambda **kw: tft.create_finetune_state(0, _finetune_cfg(), **kw),
    "ExpFineTuning": lambda **kw: tft.ExpFineTuning(_finetune_cfg(), seed=0, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card_and_raises_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(name):
    made = ENTRY_POINTS[name](device="cpu")
    state = getattr(made, "state", made)
    model = getattr(state, "model", None) or state.student
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device(torch.device("cuda", 0))


# ---- (b) what the kernels visit

def _book(rng, n_out, n_in, k, kind):
    """int32 [n_out, k] books: `strips` has whole 16-row strips and whole
    offsets empty, a ragged last strip comes from n_out % 16 != 0."""
    nbr = rng.integers(0, n_in, size=(n_out, k)).astype(np.int32)
    if kind == "full":
        return nbr
    if kind == "absent":
        return np.full((n_out, k), -1, np.int32)
    keep = rng.random((n_out, k)) < {"strips": 0.3, "sparse": 0.03}[kind]
    if kind == "strips":
        keep[16:64] = False
        keep[n_out - n_out % 16 - 16:n_out - n_out % 16, ::2] = False
        keep[:, 1] = False
    return np.where(keep, nbr, -1).astype(np.int32)


def _ints(rng, shape):
    return torch.tensor(rng.integers(-3, 4, size=shape).astype(np.float32))


BOOKS = [("strips", 203, 150, 27), ("sparse", 160, 160, 27), ("absent", 100, 100, 8),
         ("full", 77, 90, 8), ("strips", 131, 131, 125), ("full", 48, 48, 3)]


@pytest.mark.parametrize("kind,n_out,n_in,k", BOOKS)
def test_visiting_only_kept_strips_is_the_conv(kind, n_out, n_in, k):
    rng = np.random.default_rng(n_out)
    nbr = torch.tensor(_book(rng, n_out, n_in, k, kind))
    x, w = _ints(rng, (n_in, 5)), _ints(rng, (k, 5, 6))
    kept = tconv.strips_kept_plain(nbr, rows=16)
    assert kept.shape == (-(-n_out // 16), k) and kept.dtype == torch.bool
    out = torch.zeros(n_out, 6)
    visited = 0
    for s, kq in torch.nonzero(kept).tolist():
        rows = slice(16 * s, min(16 * s + 16, n_out))
        out[rows] += tconv._gather_rows(x, nbr[rows, kq]) @ w[kq]
        visited += 1
    assert torch.equal(out, tconv.gather_conv(x, nbr, w))
    # a strip is kept exactly where it holds an entry
    assert visited == int(kept.sum())
    if kind == "absent":
        assert visited == 0
    if kind == "full":
        assert bool(kept.all())
    if kind == "strips":
        assert not kept[1:4].any() and not kept[:, 1].any() and kept.any()


@pytest.mark.parametrize("kind,n_out,n_in,k", BOOKS)
@pytest.mark.parametrize("nslices", [1, 3])
def test_visiting_only_compact_pairs_is_dw(kind, n_out, n_in, k, nslices):
    """dW as the kernel forms it: per offset and per row slice, the sum over
    the present pairs in row order; slices added in order."""
    rng = np.random.default_rng(n_in)
    adj = torch.tensor(_book(rng, n_in, n_out, k, kind))  # [N_in, K] -> output rows
    x, g, w = _ints(rng, (n_in, 5)), _ints(rng, (n_out, 6)), _ints(rng, (k, 5, 6))
    rows = -(-n_in // nslices)
    dw = torch.zeros(k, 5, 6)
    pairs = 0
    for kq in range(k):
        for s in range(nslices):
            v, u = tconv.compact_pairs_plain(adj, kq, slice(s * rows, (s + 1) * rows))
            assert v.dtype == u.dtype == torch.int64
            assert bool((v[1:] > v[:-1]).all()) and bool((adj[v, kq] == u).all())
            assert v.numel() == 0 or (int(v[0]) >= s * rows and int(v[-1]) < (s + 1) * rows)
            dw[kq] += x[v].T @ g[u]
            pairs += v.numel()
    assert pairs == int((adj >= 0).sum())
    assert torch.equal(dw, tconv.gather_conv_backward(x, g, adj, w)[1])


def test_strip_occupancy_tool_counts_by_the_plain_rule():
    """`tools/strip_occupancy.py`: the fill, and the kept share per strip
    height, of every kind of book of a small plan built on the CPU."""
    from gcdlss_tpu_torch.ops.plan import build_unet_plan
    from gcdlss_tpu_torch.tools import strip_occupancy as tool

    rng = np.random.default_rng(2)
    c = np.unique(rng.integers(-12, 12, size=(900, 3)), axis=0)[:500].astype(np.int32)
    coords = np.zeros((512, 4), np.int32)
    coords[:len(c), 1:] = c
    plan = build_unet_plan(torch.tensor(coords), torch.arange(512) < len(c),
                           (512, 256, 128, 64, 32))
    named = tool.books(plan)
    assert [n for n, _ in named][:2] == ["stem L0 k5", "L0 k3"] and len(named) == 1 + 5 + 8
    for _, nbr in named:
        r = tool.occupancy(nbr)
        assert r["fill"] == pytest.approx(float((nbr >= 0).float().mean()))
        shares = [r[f"h{h}"] for h in tool.STRIPS]
        assert r["fill"] <= shares[0] + 1e-6 and shares == sorted(shares)
        assert r["h16"] == pytest.approx(float(tconv.strips_kept_plain(nbr).float().mean()))


# ---- (c) the wrappers' arguments on the CPU, and the convs against JAX

def _bf16(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def conv_case():
    rng = np.random.default_rng(21)
    n, k, ci, co = 300, 27, 16, 24
    # a symmetric submanifold-like book: adjoint = columns reversed
    nbr = np.full((n, k), -1, np.int32)
    for kq in range(k // 2):
        u = rng.permutation(n)[:120]
        v = rng.permutation(n)[:120]
        nbr[u, kq] = v
        nbr[v, k - 1 - kq] = u
    nbr[:, k // 2] = np.arange(n)
    x = _bf16(rng.standard_normal((n, ci)))
    w = _bf16(rng.standard_normal((k, ci, co)) * 0.1)
    g = _bf16(rng.standard_normal((n, co)))
    return nbr, x, w, g


def test_out_dtype_bf16_is_the_cast_of_the_f32_result(conv_case):
    nbr, x, w, g = conv_case
    nbr_t = torch.tensor(nbr)
    xb, wb, gb = (torch.tensor(a).bfloat16() for a in (x, w, g))
    out32 = tfused.gather_gemm(xb, nbr_t, wb)
    assert out32.dtype == torch.float32
    out16 = tfused.gather_gemm(xb, nbr_t, wb, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16 and torch.equal(out16, out32.to(torch.bfloat16))
    dx32, dw32 = tfused.gather_gemm_backward(xb, gb, nbr_t, wb)
    dx16, dw16 = tfused.gather_gemm_backward(xb, gb, nbr_t, wb, out_dtype=torch.bfloat16)
    assert torch.equal(dx16, dx32.to(torch.bfloat16))
    assert dw16.dtype == torch.float32 and torch.equal(dw16, dw32)
    with pytest.raises(TypeError):
        tfused.gather_gemm(xb, nbr_t, wb, out_dtype=torch.float16)


def test_reverse_reads_the_column_reversed_book(conv_case):
    nbr, x, w, g = conv_case
    nbr_t = torch.tensor(nbr)
    xt, wt, gt = (torch.tensor(a) for a in (x, w, g))
    flipped = nbr_t.flip(1).contiguous()
    got = tfused.gather_gemm_backward(xt, gt, nbr_t, wt, reverse=True)
    ref = tconv.gather_conv_backward(xt, gt, flipped, wt)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_need_dx_false_returns_no_dx(conv_case):
    nbr, x, w, g = conv_case
    nbr_t = torch.tensor(nbr)
    xt, wt, gt = (torch.tensor(a) for a in (x, w, g))
    dx, dw = tfused.gather_gemm_backward(xt, gt, nbr_t, wt, need_dx=False)
    assert dx is None
    assert torch.equal(dw, tconv.gather_conv_backward(xt, gt, nbr_t, wt)[1])


def _close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(np.abs(ref).max(), 1e-6))


@pytest.mark.parametrize("x_needs_grad", [True, False])
def test_subm_conv_matches_jax_with_and_without_dx(conv_case, x_needs_grad):
    """The no-dX branch (an input that needs no gradient, as the stem's):
    the output and dW are the same, and no gradient reaches x."""
    nbr, x, w, g = conv_case
    xt = torch.tensor(x, requires_grad=x_needs_grad)
    wt = torch.tensor(w, requires_grad=True)
    out = tfused.subm_conv(xt, torch.tensor(nbr), wt)
    (out * torch.tensor(g)).sum().backward()
    jout, vjp = jax.vjp(lambda a, b: jconv.gather_conv(a, jnp.asarray(nbr), b,
                                                       symmetric_adjoint=True),
                        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g, jout.dtype))
    _close(out.detach().numpy(), np.asarray(jout, np.float32))
    _close(wt.grad.numpy(), np.asarray(jdw))
    if x_needs_grad:
        _close(xt.grad.numpy(), np.asarray(jdx))
    else:
        assert xt.grad is None


@pytest.mark.parametrize("x_needs_grad", [True, False])
def test_pool_conv_matches_jax_with_and_without_dx(x_needs_grad):
    rng = np.random.default_rng(9)
    n_fine, n_coarse, ci, co = 240, 70, 8, 12
    parent = rng.integers(0, n_coarse, n_fine).astype(np.int32)
    dcode = np.zeros(n_fine, np.int32)
    children = np.full((n_coarse, 8), -1, np.int32)
    upmap = np.full((n_fine, 8), -1, np.int32)
    for f in range(n_fine):  # each coarse row takes at most one child per offset
        free = np.flatnonzero(children[parent[f]] < 0)
        if len(free) == 0:
            continue
        dcode[f] = free[0]
        children[parent[f], free[0]] = f
        upmap[f, free[0]] = parent[f]
    x = _bf16(rng.standard_normal((n_fine, ci)))
    w = _bf16(rng.standard_normal((8, ci, co)) * 0.2)
    g = _bf16(rng.standard_normal((n_coarse, co)))
    xt = torch.tensor(x, requires_grad=x_needs_grad)
    wt = torch.tensor(w, requires_grad=True)
    out = tfused.pool_conv(xt, torch.tensor(children), torch.tensor(upmap), wt)
    (out * torch.tensor(g)).sum().backward()
    jout, vjp = jax.vjp(lambda a, b: jconv.gather_conv(a, jnp.asarray(children), b),
                        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g, jout.dtype))
    _close(out.detach().numpy(), np.asarray(jout, np.float32))
    _close(wt.grad.numpy(), np.asarray(jdw))
    if x_needs_grad:
        _close(xt.grad.numpy(), np.asarray(jdx))
    else:
        assert xt.grad is None
