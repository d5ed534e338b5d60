"""The conv-component functions of the port (`ops/conv_parts.py`, the plain
versions that the CUDA wrappers take on CPU tensors) against the JAX package
and numpy, and the `tools/conv_parts` entry point on the CPU.

Inputs are f32 arrays of bf16-representable values, made from a seed with
numpy and handed to both sides; both sum in f32, in another order. Tolerance:
1e-5 of the reference's largest magnitude.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcdlss_tpu.ops import conv as jconv
from gcdlss_tpu.ops.plan import build_unet_plan
from gcdlss_tpu_torch.ops import conv_parts as cp
from gcdlss_tpu_torch.tools import conv_parts as tool

N = 4096
K = 27
TOL = 1e-5


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(np.abs(ref).max(), 1e-6))


@pytest.fixture(scope="module")
def book():
    """A level-0 k=3 book built by the JAX package's plan."""
    rng = np.random.default_rng(7)
    pts = rng.integers(-22, 22, size=(5200, 3)).astype(np.int32)
    b = rng.integers(0, 2, size=(5200, 1)).astype(np.int32)
    c = np.unique(np.concatenate([b, pts], 1), axis=0)[: int(N * 0.9)]
    coords = np.zeros((N, 4), np.int32)
    coords[: len(c)] = c
    valid = np.arange(N) < len(c)
    plan = jax.jit(build_unet_plan, static_argnames=("caps", "presorted"))(
        jnp.asarray(coords), jnp.asarray(valid), caps=(N, 256, 256, 256, 256), presorted=True)
    nbr = np.asarray(plan.levels[0].nbr3)
    assert nbr.shape == (N, K) and 0.05 < (nbr >= 0).mean() < 0.9
    return nbr, valid


def _x(valid, c, seed):
    rng = np.random.default_rng(seed)
    return _bf16(rng.standard_normal((N, c)) * valid[:, None])


def _w(c, seed):
    return _bf16(np.random.default_rng(seed).standard_normal((K, c, c)) * (2.0 / (K * c)) ** 0.5)


@pytest.mark.parametrize("c", [16, 32])
def test_gather_sum_matches_jax_conv_with_identity_weights(book, c):
    """P2 is the conv with W[k] = I."""
    nbr, valid = book
    x = _x(valid, c, c)
    eye = np.broadcast_to(np.eye(c, dtype=np.float32), (K, c, c))
    ref = jconv.gather_conv(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(eye))
    got = cp.gather_sum(torch.tensor(x), torch.tensor(nbr))
    _close(got.numpy(), np.asarray(ref, np.float32))
    assert cp.gather_sum.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("index", ["static", "index_only"])
def test_gather_sum_static_modes(book, index):
    nbr, valid = book
    x = _x(valid, 16, 3)
    got = cp.gather_sum(torch.tensor(x), torch.tensor(nbr), index, unroll=True).numpy()
    if index == "static":
        _close(got, (x * np.float32(K)).astype(np.float32))
    else:
        np.testing.assert_array_equal(got, nbr.sum(1, dtype=np.int32)[:, None])


@pytest.mark.parametrize("c", [16, 32])
def test_onehot_conv_matches_jax_conv(book, c):
    """P4 is the conv itself, every entry included."""
    nbr, valid = book
    x, w = _x(valid, c, c + 1), _w(c, c + 2)
    ref = jconv.gather_conv(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(w))
    got, far = cp.onehot_conv(torch.tensor(x), torch.tensor(nbr), torch.tensor(w))
    _close(got.numpy(), np.asarray(ref, np.float32))
    assert far.dtype == torch.int32 and 0 <= int(far) <= (nbr >= 0).sum()


def test_onehot_far_count(book):
    """The direct-gather count against a loop over (block, k) in numpy."""
    nbr, _ = book
    want = 0
    for b0 in range(0, N, cp.ONEHOT_ROWS):
        for k in range(K):
            col = nbr[b0:b0 + cp.ONEHOT_ROWS, k]
            col = col[col >= 0]
            if len(col):
                want += int((col - col.min() >= cp.ONEHOT_SUBWIN).sum())
    assert int(cp.onehot_far_plain(torch.tensor(nbr))) == want
    # a random book spreads each block's entries over all rows
    rnd = np.random.default_rng(0).integers(-1, N, (N - 7, K)).astype(np.int32)
    got = int(cp.onehot_far_plain(torch.tensor(rnd)))
    assert 0.8 * (rnd >= 0).sum() < got <= (rnd >= 0).sum()


@pytest.mark.parametrize("c", [16, 32])
def test_tile_gemm_matches_shifted_matmuls(book, c):
    _, valid = book
    x, w = _x(valid, c, c + 3), _w(c, c + 4)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    rows = jnp.arange(N)
    ref = sum(jnp.dot(xj[jnp.clip(rows + k - K // 2, 0, N - 1)], wj[k],
                      precision=jax.lax.Precision.HIGHEST) for k in range(K))
    got = cp.tile_gemm(torch.tensor(x), torch.tensor(w))
    _close(got.numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("random", [False, True], ids=["sequential", "random"])
@pytest.mark.parametrize("layout", cp.LAYOUTS)
def test_window_sum_matches_numpy(book, layout, random):
    """P1 against numpy window sums; the three layouts hold the same values."""
    _, valid = book
    x = _x(valid, 16, 5)
    window, block = 2048, 256
    ws = cp.window_starts(N, block, window, random=random)
    assert ws.shape == (N // block,) and int(ws.min()) >= 0 and int(ws.max()) <= N - window
    if not random:
        np.testing.assert_array_equal(ws.numpy(), np.minimum(np.arange(N // block) * block,
                                                             N - window))
    held = cp.to_layout(torch.tensor(x), layout)
    assert held.is_contiguous()
    assert held.shape == {"rows": (N, 16), "cols": (16, N), "tiles": (N // 128, 16, 128)}[layout]
    np.testing.assert_array_equal(cp.from_layout(held, layout).numpy(), x)
    ref = np.stack([x[s:s + window].astype(np.float64).sum(0) for s in ws.numpy()])
    got = cp.window_sum(held, ws, window, layout, buffers=1 + random)
    _close(got.numpy(), ref.astype(np.float32))


def test_wrappers_reject_bad_arguments(book):
    nbr, valid = book
    x, t = torch.tensor(_x(valid, 16, 6)), torch.tensor(nbr)
    ws = cp.window_starts(N, 256, 2048)
    with pytest.raises(ValueError):
        cp.window_sum(x, ws, 2048, "diagonal")
    with pytest.raises(ValueError):
        cp.window_sum(x, ws, 2048, "rows", buffers=3)
    with pytest.raises(ValueError):
        cp.gather_sum(x, t, "sometimes")
    with pytest.raises(ValueError):
        cp.gather_sum(x[:100], t, "static")
    with pytest.raises(ValueError):
        cp.to_layout(x[:100], "tiles")


def test_tool_prints_one_line_per_mode(capsys, tmp_path):
    out_file = tmp_path / "parts.json"
    rc = tool.main(["--device", "cpu", "--rows", "4096", "--channels", "16", "--reps", "1",
                    "--json-out", str(out_file)])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert rows == json.loads(out_file.read_text())
    modes = [r["mode"] for r in rows]
    assert len(modes) == len(set(modes))
    # 3 layouts x (1 or 2 buffers, sequential) + 3 random, at the one window
    # that fits 4096 rows; 3 index modes x rolled/unrolled; product, onehot, full
    assert len([m for m in modes if m.startswith("stage ")]) == 9
    assert len([m for m in modes if m.startswith("gather ")]) == 6
    assert modes[-3:] == ["product", "onehot", "full"]
    for r in rows:
        assert r["rows"] == 4096 and r["channels"] == 16 and r["tpu_tool"].startswith("tools/")
        assert r["max_abs_err"] <= r["tolerance"] * r["ref_scale"]
        assert r["ms"] > 0 and r["bytes"] >= r["min_bytes"] > 0 and r["bound_ms"] > 0
        assert r["device"].startswith("cpu")
    assert {r["part"] for r in rows} == {"P1", "P2", "P3", "P4", "K1"}
    table = [ln for ln in lines if ln.startswith("  ") and ln.endswith(" of K1")]
    assert len(table) == 11 and "whole conv" in table[0] and "left over" in table[-1]
    # the modes that one PyTorch call computes carry its time, the others null
    with_library = {"product"} | {m for m in modes if m.startswith("gather ")}
    assert {r["mode"] for r in rows if r["library_ms"] is not None} == with_library
    assert len([ln for ln in table if "by the library" in ln]) == 2


def test_tool_argument_errors():
    with pytest.raises(SystemExit):
        tool.main(["--device", "cpu", "--rows", "4096"])
    with pytest.raises(SystemExit):
        tool.main(["--device", "cpu", "--rows", "4000", "--channels", "16"])
