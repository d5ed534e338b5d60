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
from gcdlss_tpu_torch.utils.adversarial import (GATHER_SUM_CASES, ONEHOT_CASES, TILE_GEMM_SHAPES,
                                                WINDOW_SUM_CASES, window_starts,
                                                book as adversarial_book)

N = 4096
K = 27
TOL = 1e-5


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


def _legacy_plan():
    """The JAX tools' window rule (`tools/legacy_plan.py`), loaded from its file."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "legacy_plan.py"
    spec = importlib.util.spec_from_file_location("legacy_plan", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.plan_windows_legacy


def test_onehot_far_count_is_the_jax_tools_rule(book):
    """P4's far rule is the JAX one-hot tool's (`plan_windows_legacy`, the
    plan of `tools/kernel_variants_bench.py` `mk_onehot`) at the port's
    constants, with a window over all of x, less the TPU's alignment of each
    start down to 128 rows (its lane tiling): on the book with every row
    index times 128, where every start is aligned, the counts are equal; on
    the book itself the aligned start can only put more entries outside."""
    nbr, _ = book
    plan_windows_legacy = _legacy_plan()
    rnd = np.random.default_rng(2).integers(-1, N, (N, K)).astype(np.int32)
    for b in (nbr, rnd):
        port = int(cp.onehot_far_plain(torch.tensor(b)))
        scaled = np.where(b >= 0, b * 128, -1).astype(np.int32)
        *_, far = plan_windows_legacy(jnp.asarray(scaled), block=cp.ONEHOT_ROWS, window=128 * N,
                                      subwin=128 * cp.ONEHOT_SUBWIN)
        assert port == int(far)
        *_, far_aligned = plan_windows_legacy(jnp.asarray(b), block=cp.ONEHOT_ROWS, window=N,
                                              subwin=cp.ONEHOT_SUBWIN)
        assert port <= int(far_aligned)
    assert int(cp.onehot_far_plain(torch.tensor(rnd))) > 0.5 * (rnd >= 0).sum()


def test_onehot_tiles_count_by_brute_force(book):
    """The k16 tiles of its window a 16-row strip's entries fall into (the
    one-hot products P4 runs for a (strip, offset)), against a loop."""
    nbr, _ = book
    rnd = np.random.default_rng(3).integers(-1, 700, (N - 9, K)).astype(np.int32)
    for b in (nbr, rnd):
        got = cp.onehot_tiles_plain(torch.tensor(b)).numpy()
        assert got.shape == (-(-len(b) // 16), K)
        want = np.zeros_like(got)
        for b0 in range(0, len(b), cp.ONEHOT_ROWS):
            blk = b[b0:b0 + cp.ONEHOT_ROWS]
            for k in range(K):
                col = blk[:, k]
                if not (col >= 0).any():
                    continue
                start = col[col >= 0].min()
                for s0 in range(0, len(blk), 16):
                    rel = col[s0:s0 + 16]
                    rel = rel[(rel >= 0) & (rel - start < cp.ONEHOT_SUBWIN)] - start
                    want[(b0 + s0) // 16, k] = len(set((rel // 16).tolist()))
        np.testing.assert_array_equal(got, want)
    assert 0 < got.max() <= cp.ONEHOT_SUBWIN // 16


@pytest.mark.parametrize("n_out,n_in,k,c,kind", GATHER_SUM_CASES)
def test_gather_sum_on_adversarial_books(n_out, n_in, k, c, kind):
    """P2's plain versions on the books the card's checks use (ragged row
    counts, no entry, every entry, entries at the last row of x, N_in !=
    N_out), against numpy in f64."""
    b = adversarial_book(n_out, n_in, k, kind, seed=n_out + c)
    x = _bf16(np.random.default_rng(c).standard_normal((n_in, c)))
    ref = np.zeros((n_out, c))
    for kq in range(k):
        ref += np.where(b[:, kq:kq + 1] >= 0, x[np.maximum(b[:, kq], 0)], 0.0)
    got = cp.gather_sum(torch.tensor(x), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(np.abs(ref).max(), 1e-6))
    np.testing.assert_array_equal(cp.gather_sum(torch.tensor(x), torch.tensor(b), "index_only"),
                                  b.sum(1, dtype=np.int32)[:, None])
    if n_in == n_out:
        _close(cp.gather_sum(torch.tensor(x), torch.tensor(b), "static").numpy(),
               (x * np.float32(k)).astype(np.float32))


@pytest.mark.parametrize("n_out,n_in,k,ci,co,kind", ONEHOT_CASES)
def test_onehot_conv_on_adversarial_books(n_out, n_in, k, ci, co, kind):
    """P4's plain version on the books the card's checks use, against a
    numpy conv in f64 (1e-5 of its scale), and its far count against a loop."""
    b = adversarial_book(n_out, n_in, k, kind, seed=n_out + ci + co)
    rng = np.random.default_rng(ci + co)
    x = _bf16(rng.standard_normal((n_in, ci)))
    w = _bf16(rng.standard_normal((k, ci, co)) * (2.0 / (k * ci)) ** 0.5)
    ref = sum(np.where(b[:, kq:kq + 1] >= 0, x[np.maximum(b[:, kq], 0)], 0.0) @ w[kq]
              for kq in range(k))
    got, far = cp.onehot_conv(torch.tensor(x), torch.tensor(b), torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL * max(np.abs(ref).max(), 1e-6))
    want = 0
    for b0 in range(0, n_out, cp.ONEHOT_ROWS):
        for kq in range(k):
            col = b[b0:b0 + cp.ONEHOT_ROWS, kq]
            col = col[col >= 0]
            want += int((col - col.min() >= cp.ONEHOT_SUBWIN).sum()) if len(col) else 0
    assert int(far) == want


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


@pytest.mark.parametrize("n,k,ci,co", TILE_GEMM_SHAPES)
def test_tile_gemm_plain_matches_jax_conv_on_shifted_rows(n, k, ci, co):
    """P3's function is the JAX conv on the book nbr[u, j] = clip(u + j - K // 2,
    0, N - 1), at ragged N, even and odd K, Co that is no multiple of 8.
    Both sum K * Ci products in f32, in another order: 1e-4 of the
    reference's largest magnitude."""
    rng = np.random.default_rng(n + 31 * k + ci + co)
    x = _bf16(rng.standard_normal((n, ci)))
    w = _bf16(rng.standard_normal((k, ci, co)) * (2.0 / (k * ci)) ** 0.5)
    nbr = np.clip(np.arange(n)[:, None] + np.arange(k)[None, :] - k // 2, 0, n - 1).astype(np.int32)
    ref = np.asarray(jconv.gather_conv(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(w)),
                     np.float32)
    before = cp.tile_gemm.launches
    got = cp.tile_gemm(torch.tensor(x), torch.tensor(w)).numpy()
    assert cp.tile_gemm.launches == before  # CPU tensors take the plain version
    assert got.shape == ref.shape == (n, co) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_tile_gemm_refusals():
    """What P3's wrapper refuses on any device, and the rule for what its
    kernel serves on the card."""
    x, w = torch.zeros(64, 16), torch.zeros(3, 16, 8)
    for bad_x, bad_w in ((x[:, :12], w[:, :12]),  # Ci no multiple of 8
                         (x, w[:, :8]),           # x and w disagree
                         (x[:0], w), (x, w[:0]), (x, w[:, :, :0]),  # empty
                         (x[0], w), (x, w[0])):   # wrong ranks
        with pytest.raises(ValueError):
            cp.tile_gemm(bad_x, bad_w)
    # the window of 256 + K - 1 rows and three stages of W must fit 232,448 bytes
    assert all(cp.tile_gemm_fits(k, ci, co) for k, ci, co in
               ((27, 96, 96), (27, 256, 256), (1, 8, 20), (90, 256, 256), (125, 96, 20)))
    assert not any(cp.tile_gemm_fits(k, ci, co) for k, ci, co in
                   ((91, 256, 256), (27, 384, 96), (27, 512, 256)))
    # every shape the tool, the tests and the smoke run is served
    assert all(cp.tile_gemm_fits(k, ci, co) for _, k, ci, co in TILE_GEMM_SHAPES)


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


@pytest.mark.parametrize("n,c,window,nb,kind", WINDOW_SUM_CASES)
def test_window_sum_plain_on_adversarial_cases(n, c, window, nb, kind):
    """P1's plain version (the wrapper on CPU tensors) against numpy f64
    window sums at `WINDOW_SUM_CASES`, in every layout that holds N."""
    ws = window_starts(n, window, nb, kind, seed=n + nb)
    assert ws.shape == (nb,) and 0 <= ws.min() and ws.max() <= n - window
    x = _bf16(np.random.default_rng(nb).standard_normal((n, c)))
    ref = np.stack([x[s:s + window].astype(np.float64).sum(0) for s in ws])
    for layout in cp.LAYOUTS:
        if layout == "tiles" and n % cp.TILE_ROWS:
            continue
        got = cp.window_sum(cp.to_layout(torch.tensor(x), layout), torch.as_tensor(ws), window,
                            layout)
        _close(got.numpy(), ref.astype(np.float32))


def _schedule_cases():
    """(id, starts, N, W): `WINDOW_SUM_CASES` and the tool's sequential and
    random starts at both of its shapes and windows."""
    cases = [(f"{kind}-N{n}-W{w}-NB{nb}", window_starts(n, w, nb, kind, seed=n + nb), n, w)
             for n, _, w, nb, kind in WINDOW_SUM_CASES]
    for n, _, _ in tool.DEFAULT_CONFIGS:
        for w in tool.WINDOWS:
            for rand in (False, True):
                ws = cp.window_starts(n, tool.BLOCK, w, random=rand, align=8).numpy()
                cases.append((f"tool-N{n}-W{w}-{'random' if rand else 'sequential'}", ws, n, w))
    return cases


SCHEDULE_CASES = _schedule_cases()


@pytest.mark.parametrize("per_block", [1, 2])
@pytest.mark.parametrize("ws,n,window", [c[1:] for c in SCHEDULE_CASES],
                         ids=[c[0] for c in SCHEDULE_CASES])
def test_window_schedule_counts_every_row_once(ws, n, window, per_block):
    """P1's rule (`window_schedule_plain`), per cluster of 8 blocks of 1 or 2
    consecutive windows: the blocks' shares are disjoint 8-aligned row ranges
    that make up the union of the windows' bodies, so each union row is
    staged once; each window's head, segments and tail count each of its rows
    exactly once; each segment lies inside the union, and the ranks it lists
    are exactly those whose share meets it."""
    sched = cp.window_schedule_plain(ws, window, per_block)
    assert [i for cl in sched for i in cl["windows"]] == list(range(len(ws)))
    span = cp.WINDOW_CLUSTER * per_block
    assert all(len(cl["windows"]) <= span and len(cl["shares"]) == cp.WINDOW_CLUSTER
               for cl in sched)
    for cl in sched:
        union = np.zeros(n + 1, np.int32)
        for lo, hi in cl["union"]:
            assert lo % 8 == 0 and hi % 8 == 0 and 0 <= lo < hi <= n
            union[lo] += 1
            union[hi] -= 1
        union = np.cumsum(union)[:n]
        assert union.max(initial=0) <= 1
        owner = np.full(n, -1)
        staged = np.zeros(n + 1, np.int32)
        for rank, share in enumerate(cl["shares"]):
            for lo, hi in share:
                assert lo % 8 == 0 and hi % 8 == 0
                staged[lo] += 1
                staged[hi] -= 1
                owner[lo:hi] = rank
        np.testing.assert_array_equal(np.cumsum(staged)[:n], union)
        assert len(cl["bounds"]) <= 2 * len(cl["windows"])
        for i in cl["windows"]:
            part, s = cl["parts"][i], int(ws[i])
            count = np.zeros(window + 1, np.int32)  # rows s .. s + window - 1
            pieces = [part["head"], part["tail"]] + [seg for seg, _ in part["segments"]]
            for lo, hi in pieces:
                assert s <= lo <= hi <= s + window
                count[lo - s] += 1
                count[hi - s] -= 1
            assert (np.cumsum(count)[:window] == 1).all()
            for lo, hi in (part["head"], part["tail"]):
                assert hi - lo < 8 or not part["segments"]
            for (a, b), ranks in part["segments"]:
                assert union[a:b].all() and a in cl["bounds"] and b in cl["bounds"]
                assert ranks == np.unique(owner[a:b]).tolist()
    if n == 262_144 and window == tool.WINDOWS[0] and not ws[1] % 256:
        # sequential starts: the union of 8 or 16 windows of 2048 rows 256 apart
        assert len(sched[0]["union"]) == 1
        assert sched[0]["union"][0] == (0, (span - 1) * 256 + 2048)
        staged = cp.window_staged_rows(ws, window, per_block) * 96 * 2
        assert staged < {1: 95e6, 2: 73e6}[per_block]  # against 403 MB per block


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
    assert len(table) == 13 and "whole conv" in table[0] and "left over" in table[-1]
    assert len([ln for ln in table if "P3 x strips kept" in ln]) == 1  # the product at K1's work
    # the modes that one PyTorch call computes carry its time, the others null
    with_library = ({"product"} | {m for m in modes if m.startswith("gather ")}
                    | {m for m in modes if m.startswith("stage rows") and "sequential" in m})
    assert {r["mode"] for r in rows if r["library_ms"] is not None} == with_library
    assert len([ln for ln in table if "by the library" in ln]) == 3


def test_tool_argument_errors():
    with pytest.raises(SystemExit):
        tool.main(["--device", "cpu", "--rows", "4096"])
    with pytest.raises(SystemExit):
        tool.main(["--device", "cpu", "--rows", "4000", "--channels", "16"])
