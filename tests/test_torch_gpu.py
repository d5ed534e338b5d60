"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device: without one the module skips whole and
yields no item. This file imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

Inputs are bf16 on both sides; the kernels and the plain versions both sum in
f32, so they differ only in summation order: tolerance 1e-4 of the
reference's scale. Neighbor maps must be equal. The conv parts (P1-P4) run
every mode of `tools/conv_parts.py` at small and at its full-width shapes,
with that tool's tolerances.
"""

import functools

import numpy as np
import pytest
import torch

from gcdlss_tpu_torch.ops import conv as plain
from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
from gcdlss_tpu_torch.ops.coords import SENTINEL_HI
from gcdlss_tpu_torch.ops.plan import _column_ranks, build_unet_plan, join_neighbor_map
from gcdlss_tpu_torch.ops.plan_kernel import (CUBE_MAP_MAX_K1, cube_candidates_map,
                                              cube_candidates_plain, cube_direct_rule,
                                              cube_neighbor_map)
from gcdlss_tpu_torch.utils.adversarial import (GATHER_SUM_CASES, ONEHOT_CASES, TILE_GEMM_SHAPES,
                                                WINDOW_SUM_CASES, neighbor_map_levels)

pytestmark = pytest.mark.gpu
if not torch.cuda.is_available():
    # no items where there is no card: the CPU suite's collected count stays
    # under its limit (ROADMAP.md, "Test budget")
    pytest.skip("needs a CUDA device", allow_module_level=True)
CAPS = (4096, 2048, 1024, 512, 256)
NCC_SHIFT = 8.0  # NCC logits far above every candidate threshold


@pytest.fixture(scope="module")
def plan():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    pts = rng.integers(-25, 25, size=(5200, 3))
    b = rng.integers(0, 2, size=(5200, 1))
    c = np.unique(np.concatenate([b, pts], 1), axis=0)[: int(CAPS[0] * 0.9)]
    coords = np.zeros((CAPS[0], 4), np.int32)
    coords[: len(c)] = c
    valid = np.arange(CAPS[0]) < len(c)
    dev = torch.device("cuda")
    return build_unet_plan(torch.as_tensor(coords, device=dev),
                           torch.as_tensor(valid, device=dev), CAPS, presorted=True)


def _close(got, ref):
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def _for_each(cases, check) -> None:
    """`check(*case)` for every case; raises once all have run, naming every
    case that failed. (The card-only checks run as loops inside two tests,
    the kernel families and the paths.)"""
    failed = []
    for case in cases:
        try:
            check(*case)
        except Exception as exc:  # noqa: BLE001 - every case runs; all are reported
            failed.append(f"case {case}: {type(exc).__name__}: {exc}")
    if failed:
        raise AssertionError(f"{len(failed)} of {len(cases)} cases failed:\n" + "\n".join(failed))


def _run_family(plan, checks) -> None:
    """Every check of a kernel family on the plan, each with all its cases;
    raises once all have run, naming every check that failed."""
    _for_each([(plan, check) for check in checks], lambda p, check: check(p))



def _gather_gemm_matches_plain(plan):
    """K1 and K2 on the plan's books: the stem, a k3 level, a down and an up
    pool, and on a cylinder plan of the plan's voxels (Cylinder3D): a K = 9
    and a K = 3 column subset of a level map (adjoint: the reversed book)
    and the 27-column paired books of a (2, 2, 2) and a (2, 2, 1) edge in
    both role orders, each against the plain versions."""
    _for_each([(plan, 1, 32, "stem"), (plan, 192, 96, "k3"), (plan, 32, 32, "down"),
               (plan, 64, 48, "up"), (plan, 64, 64, "cyl_k9"), (plan, 512, 512, "cyl_k3"),
               (plan, 64, 64, "cyl_down0"), (plan, 64, 64, "cyl_up0"),
               (plan, 256, 256, "cyl_down2"), (plan, 256, 256, "cyl_up2")],
              _check_gather_gemm_book)


def _cylinder_books(plan, kind: str):
    """(book, adjoint, x validity) of a Cylinder3D conv on the cylinder plan
    of the plan's level-0 voxels, taken as (b, rho, phi, z) bins."""
    from gcdlss_tpu_torch.models.cylinder3d import build_cyl_plan

    lvl0 = plan.levels[0]
    cyl = build_cyl_plan(lvl0.coords, lvl0.valid, CAPS)
    lv, edges = cyl.levels, cyl.edges
    if kind in ("cyl_k9", "cyl_k3"):
        book = lv[0 if kind == "cyl_k9" else 1].books[(1, 3, 3) if kind == "cyl_k9" else (3, 1, 1)]
        return book, book.flip(1), lv[0 if kind == "cyl_k9" else 1].valid
    e = int(kind[-1])
    if kind.startswith("cyl_down"):
        return edges[e].down_map, edges[e].up_map, lv[e].valid
    return edges[e].up_map, edges[e].down_map, lv[e + 1].valid


def _check_gather_gemm_book(plan, ci: int, co: int, kind: str) -> None:
    if kind.startswith("cyl"):
        nbr, adj, valid = _cylinder_books(plan, kind)
    elif kind == "stem":
        nbr, adj, valid = plan.stem_nbr, plan.stem_nbr.flip(1), plan.levels[0].valid
    elif kind == "k3":
        nbr, adj, valid = plan.levels[1].nbr3, plan.levels[1].nbr3.flip(1), plan.levels[1].valid
    elif kind == "down":
        nbr, adj, valid = plan.pools[0].children, plan.pools[0].upmap, plan.levels[0].valid
    else:
        nbr, adj, valid = plan.pools[0].upmap, plan.pools[0].children, plan.levels[1].valid
    nbr, adj = nbr.contiguous(), adj.contiguous()
    g = torch.Generator(device="cuda").manual_seed(ci)
    dev = valid.device
    k = nbr.shape[1]
    x = (torch.randn(valid.shape[0], ci, device=dev, generator=g) * valid[:, None]).bfloat16()
    w = torch.randn(k, ci, co, device=dev, generator=g).mul(0.1).bfloat16()
    cot = torch.randn(nbr.shape[0], co, device=dev, generator=g).bfloat16()
    _close(gather_gemm(x, nbr, w), plain.gather_conv(x, nbr, w))
    dx, dw = gather_gemm_backward(x, cot, adj, w)
    rdx, rdw = plain.gather_conv_backward(x, cot, adj, w)
    _close(dx, rdx)
    _close(dw, rdw)


RAGGED_GEMM_CASES = [  # (ci, co, k, n_out, n_in, off)
    (1, 20, 27, 4099, 4099, 0), (4, 32, 8, 4100, 6001, 0), (24, 256, 27, 5000, 5000, 0),
    (48, 96, 27, 4097, 4097, 1), (192, 32, 8, 6001, 4100, 0), (384, 256, 27, 4111, 4111, 1),
    (96, 96, 125, 4096, 4096, 0)]


def _gather_gemm_ragged_shapes_and_misaligned_x(plan):
    """Widths that are no multiple of 8, row counts that are no multiple of
    any tile, N_in != N_out, books without locality with empty strips and
    empty offsets, and an x that starts 2 bytes off a 16-byte boundary: served,
    in f32 and bf16, with dX skipped on request, the same bits on every run."""
    _for_each([(plan, *case) for case in RAGGED_GEMM_CASES], _check_gather_gemm_ragged)


def _check_gather_gemm_ragged(plan, ci, co, k, n_out, n_in, off) -> None:
    dev = plan.stem_nbr.device
    g = torch.Generator(device="cuda").manual_seed(ci * 1000 + co)

    def book(rows, limit):
        nbr = torch.randint(0, limit, (rows, k), device=dev, generator=g, dtype=torch.int32)
        keep = torch.rand((rows, k), device=dev, generator=g) < 0.2
        keep[rows // 3:rows // 2] = False
        keep[:, ::3] = False
        return torch.where(keep, nbr, -1)

    nbr, adj = book(n_out, n_in), book(n_in, n_out)
    store = torch.randn(n_in * ci + 1, device=dev, generator=g).bfloat16()
    x = store[off:off + n_in * ci].view(n_in, ci)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2 * off
    w = torch.randn(k, ci, co, device=dev, generator=g).mul(0.1).bfloat16()
    cot = torch.randn(n_out, co, device=dev, generator=g).bfloat16()
    out = gather_gemm(x, nbr, w)
    _close(out, plain.gather_conv(x, nbr, w))
    assert torch.equal(gather_gemm(x, nbr, w, out_dtype=torch.bfloat16), out.bfloat16())
    dx, dw = gather_gemm_backward(x, cot, adj, w)
    rdx, rdw = plain.gather_conv_backward(x, cot, adj, w)
    _close(dx, rdx)
    _close(dw, rdw)
    again = gather_gemm_backward(x, cot, adj, w)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    none, dw_only = gather_gemm_backward(x, cot, adj, w, need_dx=False)
    assert none is None and torch.equal(dw_only, dw)
    rx, rw = gather_gemm_backward(x, cot, adj.flip(1).contiguous(), w, reverse=True,
                                  out_dtype=torch.bfloat16)
    # bf16 result, offsets added in the other order: one bf16 place of the scale
    torch.testing.assert_close(rx.float(), rdx, rtol=0, atol=2 ** -7 * float(rdx.abs().max()))
    assert torch.equal(rw, dw)


def _gather_gemm_all_absent_and_full_books(plan):
    _for_each([(plan, "absent"), (plan, "full")], _check_gather_gemm_absent_full)


def _check_gather_gemm_absent_full(plan, kind: str) -> None:
    dev = plan.stem_nbr.device
    g = torch.Generator(device="cuda").manual_seed(3)
    n, k, ci, co = 4113, 27, 64, 48
    if kind == "absent":
        nbr = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    else:
        nbr = torch.randint(0, n, (n, k), device=dev, generator=g, dtype=torch.int32)
    x = torch.randn(n, ci, device=dev, generator=g).bfloat16()
    w = torch.randn(k, ci, co, device=dev, generator=g).mul(0.1).bfloat16()
    cot = torch.randn(n, co, device=dev, generator=g).bfloat16()
    out = gather_gemm(x, nbr, w)
    _close(out, plain.gather_conv(x, nbr, w))
    dx, dw = gather_gemm_backward(x, cot, nbr, w)
    rdx, rdw = plain.gather_conv_backward(x, cot, nbr, w)
    _close(dx, rdx)
    _close(dw, rdw)
    if kind == "absent":
        assert not out.any() and not dx.any() and not dw.any()


def _wrappers_reject_wrong_inputs(plan):
    nbr = plan.levels[1].nbr3
    x = torch.zeros(nbr.shape[0], 8, device=nbr.device, dtype=torch.bfloat16)
    w = torch.zeros(27, 8, 4, device=nbr.device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        gather_gemm(x.float(), nbr, w)
    with pytest.raises(ValueError):
        gather_gemm(x, nbr, w[:, :4])
    with pytest.raises(ValueError):
        gather_gemm(x.t(), nbr, w)
    with pytest.raises(TypeError):
        gather_gemm(x, nbr, w, out_dtype=torch.float16)


PLAN_MAPS = [(0, 5), (0, 3), (1, 3), (3, 3)]  # (level, k1)


def _cube_map_matches_join(plan):
    _for_each([(plan, lvl, k1) for lvl, k1 in PLAN_MAPS], _check_cube_map_plan_level)


def _check_cube_map_plan_level(plan, lvl: int, k1: int) -> None:
    kh, kl = plan.levels[lvl].key_hi, plan.levels[lvl].key_lo
    assert torch.equal(cube_neighbor_map(kh, kl, k1), join_neighbor_map(kh, kl, k1))


def _cube_map_matches_join_on_adversarial_levels(plan):
    """Voxels on the faces and corners of the coordinate field (where the
    join path's clip folds queries and its scatter-max picks the largest
    row), no voxel, one voxel, a full cube, long z runs, four equal batches,
    a level cut at its capacity; caps that are no multiple of a block's rows;
    k1 = 3, 5, 7. Bit for bit, the same bits on every launch, one launch
    counted."""
    _for_each([(plan, name, k1) for name in sorted(neighbor_map_levels()) for k1 in (3, 5, 7)],
              _check_cube_map_level)


def _check_cube_map_level(plan, name: str, k1: int) -> None:
    from gcdlss_tpu_torch.ops.coords import encode_coords, sorted_unique

    coords, cap = neighbor_map_levels()[name]
    dev = plan.stem_nbr.device
    c = torch.as_tensor(coords, device=dev)
    hi, lo = encode_coords(c, torch.ones(len(c), dtype=torch.bool, device=dev))
    (kh, kl), _, _, _ = sorted_unique(hi, lo, cap)
    before = cube_neighbor_map.launches
    got = cube_neighbor_map(kh, kl, k1)
    assert cube_neighbor_map.launches == before + 1
    assert torch.equal(got, join_neighbor_map(kh, kl, k1))
    assert torch.equal(got, cube_neighbor_map(kh, kl, k1))
    if k1 == 3:
        assert torch.equal(got.cpu(), cube_direct_rule(kh.cpu(), kl.cpu(), k1))


def _cube_map_serves_its_largest_k1(plan):
    """The widest cube the kernel's shared memory holds, on a full cube of
    12^3 voxels (every voxel in every other's reach) and on one voxel."""
    from gcdlss_tpu_torch.ops.coords import encode_coords, sorted_unique

    dev = plan.stem_nbr.device
    for name in ("dense_cube", "one_voxel"):
        coords, cap = neighbor_map_levels()[name]
        c = torch.as_tensor(coords, device=dev)
        hi, lo = encode_coords(c, torch.ones(len(c), dtype=torch.bool, device=dev))
        (kh, kl), _, _, _ = sorted_unique(hi, lo, cap)
        got = cube_neighbor_map(kh, kl, CUBE_MAP_MAX_K1)
        assert torch.equal(got, join_neighbor_map(kh, kl, CUBE_MAP_MAX_K1))


def _cube_map_rejects_wrong_inputs(plan):
    kh, kl = plan.levels[1].key_hi, plan.levels[1].key_lo
    with pytest.raises(TypeError):
        cube_neighbor_map(kh.long(), kl, 3)
    with pytest.raises(ValueError):
        cube_neighbor_map(kh, kl[:-1], 3)
    with pytest.raises(ValueError):
        cube_neighbor_map(kh[::2], kl[::2], 3)  # not contiguous
    with pytest.raises(ValueError):
        cube_neighbor_map(kh, kl.cpu(), 3)
    for k1 in (1, 4, CUBE_MAP_MAX_K1 + 2):
        with pytest.raises(ValueError):
            cube_neighbor_map(kh, kl, k1)


def _cube_candidates_matches_plain_and_k3(plan):
    _for_each([(plan, lvl, k1) for lvl, k1 in PLAN_MAPS], _check_cube_candidates_plan_level)


def _check_cube_candidates_plan_level(plan, lvl: int, k1: int) -> None:
    kh, kl = plan.levels[lvl].key_hi, plan.levels[lvl].key_lo
    p, has = _column_ranks(kh != SENTINEL_HI, kh, kl, k1)
    before = cube_candidates_map.launches
    got = cube_candidates_map(kh, kl, p, has, k1)
    assert cube_candidates_map.launches == before + 1
    assert torch.equal(got, cube_candidates_plain(kh, kl, p, has, k1))
    assert torch.equal(got, cube_neighbor_map(kh, kl, k1))


def _cube_candidates_on_adversarial_levels(plan):
    """K4 on the levels no scan makes (caps no multiple of a tile's rows),
    k1 = 3, 5: bit for bit against its plain version, the same bits on every
    launch, one launch counted, and equal to K3 off the field's faces."""
    import chip_smoke

    dev = plan.stem_nbr.device
    _for_each([(dev, name, k1) for name in sorted(neighbor_map_levels()) for k1 in (3, 5)],
              chip_smoke.check_cube_candidates_level)


def _plan_kernel_1_builds_the_same_plan(plan):
    lv0 = plan.levels[0]
    other = build_unet_plan(lv0.coords, lv0.valid, CAPS, plan_kernel=1)
    assert torch.equal(other.stem_nbr, plan.stem_nbr)
    for a, b in zip(other.levels, plan.levels):
        assert torch.equal(a.nbr3, b.nbr3)


def _cube_candidates_rejects_wrong_inputs(plan):
    kh, kl = plan.levels[1].key_hi, plan.levels[1].key_lo
    p, has = _column_ranks(kh != SENTINEL_HI, kh, kl, 3)
    with pytest.raises(TypeError):
        cube_candidates_map(kh, kl, p, has.int(), 3)
    with pytest.raises(ValueError):
        cube_candidates_map(kh, kl, p[:, :-1], has, 3)
    with pytest.raises(ValueError):
        cube_candidates_map(kh, kl, p, has, 4)


# ---- conv parts (P1-P4), small and at the tool's full-width shapes

PART_SHAPES = [(4096, 16, 0.05), (4096, 32, 0.4), (262_144, 96, 0.05), (131_072, 256, 0.4)]


@functools.lru_cache(maxsize=None)
def _parts(shape):
    """(x, w, nbr) on the card at one of the tool's shapes, every mode of the
    tool's table on them, and the tool's tolerances (made once a shape)."""
    from gcdlss_tpu_torch.tools import conv_parts as tool

    rows, c, voxel = shape
    dev = torch.device("cuda")
    nbr, valid, _ = tool.level0_book(rows, voxel, 0, dev)
    g = torch.Generator(device="cuda").manual_seed(c)
    x = (torch.randn(rows, c, device=dev, generator=g) * valid[:, None]).bfloat16()
    w = torch.randn(27, c, c, device=dev, generator=g).mul((2.0 / (27 * c)) ** 0.5).bfloat16()
    return x, w, nbr, tool.modes(x, w, nbr, rows, c), tool.TOL


def _for_each_part_shape(plan, check) -> None:
    """`check(*_parts(shape))` at each of PART_SHAPES, the failing one named."""
    _for_each([(shape,) for shape in PART_SHAPES], lambda shape: check(*_parts(shape)))


def _conv_parts_match_plain_in_every_mode(plan):
    """Every mode of P1-P4 (layouts, windows, buffers, window starts; index
    modes rolled and unrolled; product; one-hot) against its plain version:
    P1 1e-3, P2 1e-5, P3 and P4 1e-2 of the reference's scale, index_only
    exact; at each of PART_SHAPES."""
    _for_each_part_shape(plan, _check_parts_every_mode)


def _check_parts_every_mode(x, w, nbr, modes, tol) -> None:
    from gcdlss_tpu_torch.ops import conv_parts as cp

    assert {m["part"] for m in modes} == {"P1", "P2", "P3", "P4", "K1"}
    for m in modes:
        fn = getattr(cp, m["kernel"], None) or gather_gemm
        before = fn.launches
        got, ref = m["run"](), m["plain"]()
        torch.cuda.synchronize()
        assert fn.launches == before + 1, m["mode"]
        if m.get("exact"):
            assert torch.equal(got, ref), m["mode"]
        else:
            torch.testing.assert_close(got, ref, rtol=0, msg=lambda s, m=m: f"{m['mode']}: {s}",
                                       atol=tol[m["part"]] * float(ref.abs().max()))


def _onehot_conv_far_entries(plan):
    """P4 on a book whose entries mostly lie outside their sub-windows (a
    random book) is still the conv, and counts those entries as the plain
    rule does; at each of PART_SHAPES."""
    _for_each_part_shape(plan, _check_onehot_far)


def _check_onehot_far(x, w, nbr, _, tol) -> None:
    from gcdlss_tpu_torch.ops import conv_parts as cp

    g = torch.Generator(device="cuda").manual_seed(1)
    rnd = torch.randint(-1, x.shape[0], nbr.shape, device=x.device, generator=g,
                        dtype=torch.int32)
    for book in (nbr, rnd):
        out, far = cp.onehot_conv(x, book, w)
        ref = plain.gather_conv(x, book, w)
        torch.testing.assert_close(out, ref, rtol=0, atol=tol["P4"] * float(ref.abs().max()))
        assert int(far) == int(cp.onehot_far_plain(book))
    assert int(far) > 0.8 * int((rnd >= 0).sum())


def _window_sum_unaligned_starts(plan):
    """Window starts that are no multiple of 8: the column layouts stage
    those runs element by element; at each of PART_SHAPES."""
    _for_each_part_shape(plan, _check_window_sum_unaligned)


def _check_window_sum_unaligned(x, _w, _nbr, _modes, tol) -> None:
    from gcdlss_tpu_torch.ops import conv_parts as cp

    n = x.shape[0]
    ws = (torch.arange(n // 256, dtype=torch.int32, device=x.device) * 251 + 3).clamp(max=n - 2048)
    for layout in cp.LAYOUTS:
        held = cp.to_layout(x, layout)
        for buffers in (1, 2):
            got = cp.window_sum(held, ws, 2048, layout, buffers)
            ref = cp.window_sum_plain(held, ws, 2048, layout)
            torch.testing.assert_close(got, ref, rtol=0, atol=tol["P1"] * float(ref.abs().max()))


def _window_sum_adversarial(plan):
    """P1 at `WINDOW_SUM_CASES`: NB no multiple of a cluster's 8 windows,
    equal starts, starts at 0 and N - W, unaligned starts, W = 32, N = W, C 8
    .. 256, N no multiple of 128 or 8, random starts at W 6144: every layout
    that holds the case, 1 and 2 buffers, within 1e-3 of max|plain|, two
    launches the same bits, one launch counted each."""
    from gcdlss_tpu_torch.tools.conv_parts import check_window_sum_case

    _for_each([(plan.stem_nbr.device, *case) for case in WINDOW_SUM_CASES],
              check_window_sum_case)


def _window_sum_refuses_what_the_kernel_does_not_serve(plan):
    from gcdlss_tpu_torch.ops import conv_parts as cp

    dev = plan.stem_nbr.device
    ws = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="N % 8"):  # the copy engine's pitch: N * 2 bytes
        cp.window_sum(torch.zeros(16, 1004, dtype=torch.bfloat16, device=dev), ws, 992, "cols")
    store = torch.zeros(1024 * 16 + 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        cp.window_sum(store[1:1 + 1024 * 16].view(1024, 16), ws, 512)


def _conv_parts_reject_wrong_inputs(plan):
    _for_each_part_shape(plan, _check_parts_reject)


def _check_parts_reject(x, w, nbr, _modes, _tol) -> None:
    from gcdlss_tpu_torch.ops import conv_parts as cp

    ws = cp.window_starts(x.shape[0], 256, 2048).to(x.device)
    with pytest.raises(TypeError):
        cp.window_sum(x.float(), ws, 2048)
    with pytest.raises(ValueError):
        cp.window_sum(x, ws, 2000)
    with pytest.raises(ValueError):
        cp.window_sum(x, ws.cpu(), 2048)
    with pytest.raises(TypeError):
        cp.gather_sum(x, nbr.long())
    with pytest.raises(ValueError):
        cp.gather_sum(x, nbr[:, :8].contiguous(), unroll=True)
    with pytest.raises(ValueError):
        cp.tile_gemm(x, w[:, :8].contiguous())
    with pytest.raises(ValueError):
        cp.onehot_conv(x, nbr[:, :8].contiguous(), w)


def _tile_gemm_ragged_shapes(plan):
    """P3 at `TILE_GEMM_SHAPES`: N = 1 and around a block's rows, K odd, even
    and 1, Ci from one 16-byte piece up, Co that is no multiple of 8 and two
    column tiles: within the tool's tolerance of the plain version, the same
    bits on every launch."""
    _for_each([(plan, *shape) for shape in TILE_GEMM_SHAPES], _check_tile_gemm_shape)


def _check_tile_gemm_shape(plan, n: int, k: int, ci: int, co: int) -> None:
    from gcdlss_tpu_torch.ops import conv_parts as cp
    from gcdlss_tpu_torch.tools.conv_parts import TOL

    dev = plan.stem_nbr.device
    g = torch.Generator(device="cuda").manual_seed(n + k + ci + co)
    x = torch.randn(n, ci, device=dev, generator=g).bfloat16()
    w = torch.randn(k, ci, co, device=dev, generator=g).mul((2.0 / (k * ci)) ** 0.5).bfloat16()
    before = cp.tile_gemm.launches
    out = cp.tile_gemm(x, w)
    assert cp.tile_gemm.launches == before + 1
    ref = cp.tile_gemm_plain(x, w)
    torch.testing.assert_close(out, ref, rtol=0, atol=TOL["P3"] * float(ref.abs().max()))
    assert torch.equal(out, cp.tile_gemm(x, w))


def _tile_gemm_refuses_what_the_kernel_does_not_serve(plan):
    from gcdlss_tpu_torch.ops import conv_parts as cp

    dev = plan.stem_nbr.device
    store = torch.zeros(64 * 16 + 1, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3, 16, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cp.tile_gemm(store[1:].view(64, 16), w)
    with pytest.raises(ValueError, match="shared memory"):
        cp.tile_gemm(torch.zeros(64, 512, device=dev, dtype=torch.bfloat16),
                     torch.zeros(27, 512, 8, device=dev, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        cp.tile_gemm(store[:1024].view(64, 16).float(), w)
    # the wrapper's rule for what fits is the C entry's
    from gcdlss_tpu_torch.ops import _build
    lib = _build.library()
    for k in (1, 2, 27, 64, 90, 91, 125, 343):
        for ci in (8, 24, 96, 256, 264, 384, 1032):
            for co in (1, 96, 97, 256):
                assert cp.tile_gemm_fits(k, ci, co) == (lib.gcd_tile_gemm_scratch(k, ci, co) >= 0)


def _gather_sum_ragged(plan):
    """P2 at `GATHER_SUM_CASES`, in every mode that serves the case, rolled
    and (K = 27) unrolled, at N_out 1 .. 4,097, C 8 .. 256, K 1, 8, 27, on
    books with no entry, every entry, entries at the last row of x, and N_in
    != N_out: index_only bit for bit, the others within 1e-5 of max|plain|,
    one launch each."""
    from gcdlss_tpu_torch.tools.conv_parts import check_gather_sum_case

    _for_each([(plan.stem_nbr.device, *case) for case in GATHER_SUM_CASES],
              check_gather_sum_case)


def _onehot_conv_adversarial(plan):
    """P4 at `ONEHOT_CASES`: the random book (most entries outside every
    window), no entry, a single row, every entry inside one window; Ci 8 ..
    256, Co 20 .. 256, N_in != N_out: the conv within 1e-2 of max|plain|,
    `far` as the plain rule counts it, two launches the same bits."""
    from gcdlss_tpu_torch.tools.conv_parts import check_onehot_case

    _for_each([(plan.stem_nbr.device, *case) for case in ONEHOT_CASES], check_onehot_case)


def _onehot_conv_refuses_what_the_kernel_does_not_serve(plan):
    from gcdlss_tpu_torch.ops import conv_parts as cp

    dev = plan.stem_nbr.device
    nbr = torch.zeros(64, 27, device=dev, dtype=torch.int32)
    store = torch.zeros(64 * 16 + 8, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(27, 16, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cp.onehot_conv(store[1:1 + 64 * 16].view(64, 16), nbr, w)
    with pytest.raises(ValueError):  # Ci no multiple of 8
        cp.onehot_conv(torch.zeros(64, 12, device=dev, dtype=torch.bfloat16), nbr,
                       torch.zeros(27, 12, 8, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # K above ONEHOT_MAX_K
        cp.onehot_conv(store[:64 * 16].view(64, 16), torch.zeros(64, 65, device=dev, dtype=torch.int32),
                       torch.zeros(65, 16, 8, device=dev, dtype=torch.bfloat16))


def _plan_build_waits_for_no_host_sync(plan):
    """`build_unet_plan` at the Stage-1 and Stage-2 caps of `chip_smoke.py`
    with `torch.cuda.set_sync_debug_mode("error")`: no operation of the
    build makes the host wait for the card."""
    import chip_smoke

    _for_each([(plan.stem_nbr.device, 1), (plan.stem_nbr.device, 2)], chip_smoke.plan_sync_case)


def _finetune_sides(rng, cap, scans):
    """Voxel batch dicts (numpy) of `scans` synthetic scans at capacity `cap`:
    unique coordinates in plan order, features and labels from `rng`."""
    pts = rng.integers(-20, 20, size=(2 * cap, 3))
    b = rng.integers(0, scans, size=(2 * cap, 1))
    c = np.unique(np.concatenate([b, pts], 1), axis=0)[: int(cap * 0.9)].astype(np.int32)
    coords = np.zeros((cap, 4), np.int32)
    coords[: len(c)] = c
    labels = rng.integers(0, 18, cap).astype(np.int32)
    return {"coords": coords, "feats": rng.uniform(0, 1, (cap, 1)).astype(np.float32),
            "labels": labels, "mapped_labels": labels,
            "valid": np.arange(cap) < len(c)}


def _finetune_steps_match_the_cpu(plan):
    """Two Stage-1.5 steps (pairs mixing; the Extra step with the entropy
    terms and pseudo labels) on the card (kernels) and on the CPU (plain
    versions) from the same weights with the same draws, bf16 activations on
    both: each loss part within chip_smoke's card-vs-CPU tolerance."""
    _for_each([(False,), (True,)], _check_finetune_steps)


def _check_finetune_steps(extra: bool) -> None:
    from chip_smoke import REF_TOL
    from gcdlss_tpu_torch.train import finetune as tft

    caps = (4096, 4096, 2048, 1024, 512)
    cfg = tft.FineTuneConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                             voxel_caps=caps, arch="MinkUNet14",
                             planes=(16, 16, 32, 32, 32, 16, 16, 16),
                             dtype="bfloat16", mix_mode="pairs", entropy_minimize=extra,
                             sup_voxel_cap=caps[0] // 2 if extra else 0, lr=0.05,
                             use_scheduler=False)
    rng = np.random.default_rng(9)
    sides = ([_finetune_sides(rng, caps[0] // 2, 2), _finetune_sides(rng, caps[0] // 2, 2)]
             if extra else [_finetune_sides(rng, caps[0], 2)])
    step = tft.finetune_extra_train_step if extra else tft.finetune_train_step
    metrics = {}
    for dev in ("cpu", "cuda"):
        state = tft.create_finetune_state(0, cfg, device=dev)
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in s.items()} for s in sides]
        metrics[dev] = []
        for i in range(2):
            perms = tft.draw_step_randoms(cfg, 0, i, caps[0], "cpu")["perms"]
            state, m = step(state, *batches, cfg, draws={"perms": [p.to(dev) for p in perms]})
            metrics[dev].append({k: float(v) for k, v in m.items()})
    for got, ref in zip(metrics["cuda"], metrics["cpu"]):
        for k, r in ref.items():
            assert np.isfinite(got[k]), k
            assert abs(got[k] - r) <= REF_TOL * abs(r), (k, got[k], r)


def _f32_convs_round_to_bf16_and_sum_in_f32(plan):
    """An f32 model's conv on the card: x, W and the cotangent rounded to
    bf16, K1 / K2 summing in f32, the result and dX in f32, dW in W's dtype;
    equal to the plain versions on the bf16-rounded inputs (a submanifold
    conv, a down and an up pool)."""
    _for_each([(plan, "subm"), (plan, "down"), (plan, "up")], _check_f32_conv)


def _check_f32_conv(plan, kind: str) -> None:
    from gcdlss_tpu_torch.ops.fused_conv import pool_conv, subm_conv

    if kind == "subm":
        nbr, adj, valid = plan.levels[1].nbr3, plan.levels[1].nbr3.flip(1), plan.levels[1].valid
    elif kind == "down":
        nbr, adj, valid = plan.pools[0].children, plan.pools[0].upmap, plan.levels[0].valid
    else:
        nbr, adj, valid = plan.pools[0].upmap, plan.pools[0].children, plan.levels[1].valid
    g = torch.Generator(device="cuda").manual_seed(3)
    dev = valid.device
    ci, co, k = 48, 40, nbr.shape[1]
    x = (torch.randn(valid.shape[0], ci, device=dev, generator=g) * valid[:, None]).requires_grad_()
    w = torch.randn(k, ci, co, device=dev, generator=g).mul(0.1).requires_grad_()
    cot = torch.randn(nbr.shape[0], co, device=dev, generator=g)
    before = gather_gemm.launches, gather_gemm_backward.launches
    out = subm_conv(x, nbr, w) if kind == "subm" else pool_conv(x, nbr.contiguous(),
                                                                adj.contiguous(), w)
    out.backward(cot)
    assert (gather_gemm.launches - before[0], gather_gemm_backward.launches - before[1]) == (1, 1)
    assert out.dtype == x.grad.dtype == w.grad.dtype == torch.float32
    xb, wb, gb = x.detach().bfloat16(), w.detach().bfloat16(), cot.bfloat16()
    _close(out, plain.gather_conv(xb, nbr.contiguous(), wb))
    rdx, rdw = plain.gather_conv_backward(xb, gb, adj.contiguous(), wb)
    _close(x.grad, rdx)
    _close(w.grad, rdw)
    # the rounding is what makes the difference: the f32 plain version differs
    assert not torch.equal(out, plain.gather_conv(x.detach(), nbr.contiguous(), w.detach()))


def _f16_convs_still_raise(plan):
    from gcdlss_tpu_torch.ops.fused_conv import subm_conv

    nbr, valid = plan.levels[1].nbr3, plan.levels[1].valid
    x = torch.zeros(valid.shape[0], 8, device=valid.device, dtype=torch.float16)
    w = torch.zeros(27, 8, 8, device=valid.device, dtype=torch.float16)
    with pytest.raises(TypeError):
        subm_conv(x, nbr, w)


def _discover_variants_match_the_cpu(plan):
    """One Stage-2 step of each of the eight discovery configs (the seven
    recipes beside the default one, and the default one with the point-mode
    mixed plan; MinkUNet14, f32) on the card (kernels) and on the CPU (plain
    versions) from the same weights with the same draws: each loss term
    within chip_smoke's card-vs-CPU tolerance, the card's finite.

    An f32 model's convs round x and W to bf16 on the card, so its logits
    would differ from the f32 CPU's by ~3e-3; the candidate thresholds and
    the k-means assignments turn such a difference into other candidates and
    clusters, and the novel terms then move by 5-15%. So the CPU's plain
    forward conv here rounds its operands to bf16 as the card does (f32
    sums on both sides), and the NCC heads' bias is raised by NCC_SHIFT on
    both sides, so that every unlabeled voxel passes every threshold rule
    and both sides mine the same `cand_cap` candidates. k-means runs no
    Lloyd round (`kmeans_iters=0`: each candidate goes to its nearest
    initial row), as its rounds turn a last-place difference of a feature
    into another cluster; the smoke runs the full 15 on the card."""
    from gcdlss_tpu_torch.ops import fused_conv

    def card_rounding(x, nbr, w, out_dtype=torch.float32):
        return plain.gather_conv(x.bfloat16().float(), nbr, w.bfloat16().float(), out_dtype)

    saved, fused_conv.gather_conv = fused_conv.gather_conv, card_rounding
    try:
        _check_discover_variants()
    finally:
        fused_conv.gather_conv = saved


def _check_discover_variants() -> None:
    from chip_smoke import REF_TOL
    from gcdlss_tpu_torch.main import resolve_discover_overrides
    from gcdlss_tpu_torch.train import discover as td

    caps = (4096, 4096, 2048, 1024, 512)
    rng = np.random.default_rng(11)
    sides = [_finetune_sides(rng, caps[0] // 2, 2), _finetune_sides(rng, caps[0] // 2, 2)]
    points = []
    for side in sides:  # one point a voxel, at its center
        pts = (side["coords"][:, 1:].astype(np.float32) + 0.5) * 0.05
        xyz = np.zeros((2, caps[0] // 2, 3), np.float32)
        rows = np.zeros((2, caps[0] // 2), np.int32) + caps[0] // 2
        valid = np.zeros((2, caps[0] // 2), bool)
        for b in range(2):
            sel = np.flatnonzero(side["valid"] & (side["coords"][:, 0] == b))
            xyz[b, :len(sel)], rows[b, :len(sel)], valid[b, :len(sel)] = pts[sel], sel, True
        feats = np.where(valid[..., None], side["feats"][np.minimum(rows, caps[0] // 2 - 1)], 0)
        labels = np.where(valid, side["labels"][np.minimum(rows, caps[0] // 2 - 1)], -1)
        points.append({"xyz": xyz, "feats": feats.astype(np.float32), "labels": labels,
                       "mapped_labels": labels, "valid": valid, "voxel_row": rows})
    names = ["ExpMergeDiscover_LaserMix_MeanTeacher",
             "ExpMergeDiscover_LaserMix_MeanTeacher_HybridAdaptive",
             "ExpMergeDiscover_LaserMix_MeanTeacher_Oracle_threshold",
             "ExpMergeDiscover_LaserMix_MeanTeacher_MSP_threshold",
             "ExpMergeDiscover_PolarMix_MeanTeacher", "ExpMixRealMeanTeacherDiscover",
             "ExpMergeDiscover_LaserMix_LiON_MeanTeacher", None]
    failures = []
    for name in names:
        overrides = resolve_discover_overrides(
            name or "ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive", "SemanticKITTI")
        if name is None:
            overrides["mix_plan_mode"] = "point"
        cfg = td.DiscoverConfig(num_labeled_classes=17, num_unlabeled_classes=2,
                                num_classes=19, unknown_label=17, voxel_caps=caps,
                                sup_voxel_cap=caps[0] // 2, mix_voxel_caps=caps,
                                num_sup_scans=2, point_cap=caps[0] // 2, arch="MinkUNet14",
                                planes=(16, 16, 32, 32, 32, 16, 16, 16), feat_dim=16,
                                cand_cap=512, queue_slots=4, queue_per_slot=128,
                                kmeans_iters=0,
                                use_scheduler=False, **overrides)
        draws = td.draw_step_randoms(td.create_discover_state(0, cfg, device="cpu"), cfg)
        metrics = {}
        for dev in ("cpu", "cuda"):
            state = td.create_discover_state(0, cfg, device=dev)
            with torch.no_grad():
                for model in (state.student, state.teacher):
                    model.encoder.final2.bias.add_(NCC_SHIFT)
            vbs = [{k: torch.as_tensor(v, device=dev) for k, v in s.items()} for s in sides]
            pbs = [{k: torch.as_tensor(v, device=dev) for k, v in p.items()} for p in points]
            d = {k: (tuple(x.to(dev) for x in v) if isinstance(v, tuple) else v.to(dev))
                 for k, v in draws.items()}
            _, m = td.discover_train_step(state, *vbs, cfg, draws=d, sup_pb=pbs[0],
                                          unsup_pb=pbs[1])
            metrics[dev] = {k: float(v) for k, v in m.items()}
        for k in ("loss", "sup_seg", "mse", "lasermix", "calib", "thr_loss", "novel_unsup",
                  "novel_sup", "ncc_unsup"):
            got, ref = metrics["cuda"][k], metrics["cpu"][k]
            if not (np.isfinite(got) and abs(got - ref) <= REF_TOL * abs(ref) + 1e-6):
                failures.append((name, k, got, ref))
    assert not failures, failures


def _fused_norm_matches_plain(plan):
    """The fused batch norm against its plain version on the card at every
    (rows, channels) of MinkUNet34 at the Stage-2 caps and at ragged widths
    9 and 20, bf16 and f32, in training, with frozen statistics and in
    eval, with and without the residual and the ReLU: outputs, dx,
    d_residual, dweight / dbias and the running buffers
    (`chip_smoke.check_norm_case`: bf16 within one ulp, the share off
    bounded), zero invalid rows, two runs the same bits, the launches a
    call; a backward without dx; the refusals."""
    import chip_smoke
    from gcdlss_tpu_torch.train.common import default_caps

    dev = plan.stem_nbr.device
    cases = chip_smoke.norm_cases(default_caps(chip_smoke.S2_CAP0))
    _for_each([(dev, *case) for case in cases], chip_smoke.check_norm_case)
    chip_smoke.check_norm_case(dev, 243_456, 32, torch.bfloat16, "train", False, "relu",
                               need_x=False)
    chip_smoke.norm_refusals(dev)


def test_kernel_families(plan):
    """K1/K2 (the plan's and Cylinder3D's books, ragged shapes and a
    misaligned x, all-absent and full books, the wrappers' refusals), K3
    (the plan's maps, the adversarial levels, its largest k1, refusals), K4
    (against its plain version and K3, the adversarial levels, the plan it
    builds, refusals) and P1-P4 (every mode of the conv-parts tool, the
    one-hot conv's far entries and adversarial books, the window sums'
    starts and adversarial cases, the product's and the gather sums' ragged
    shapes, every refusal) and the fused batch norm: every check runs, every
    failure is reported."""
    _run_family(plan, [
        _gather_gemm_matches_plain, _gather_gemm_ragged_shapes_and_misaligned_x,
        _gather_gemm_all_absent_and_full_books, _wrappers_reject_wrong_inputs,
        _cube_map_matches_join, _cube_map_matches_join_on_adversarial_levels,
        _cube_map_serves_its_largest_k1, _cube_map_rejects_wrong_inputs,
        _cube_candidates_matches_plain_and_k3, _cube_candidates_on_adversarial_levels,
        _plan_kernel_1_builds_the_same_plan, _cube_candidates_rejects_wrong_inputs,
        _conv_parts_match_plain_in_every_mode, _onehot_conv_far_entries,
        _window_sum_unaligned_starts, _window_sum_adversarial,
        _window_sum_refuses_what_the_kernel_does_not_serve, _conv_parts_reject_wrong_inputs,
        _tile_gemm_ragged_shapes, _tile_gemm_refuses_what_the_kernel_does_not_serve,
        _gather_sum_ragged, _onehot_conv_adversarial,
        _onehot_conv_refuses_what_the_kernel_does_not_serve, _fused_norm_matches_plain])


def test_card_paths(plan):
    """The plan build with no host sync, two Stage-1.5 steps, the f32
    convs' bf16 rounding, the f16 refusal and the eight Stage-2 configs,
    each on the card against the CPU: every check runs, every failure is
    reported."""
    _run_family(plan, [_plan_build_waits_for_no_host_sync, _finetune_steps_match_the_cpu,
                       _f32_convs_round_to_bf16_and_sum_in_f32, _f16_convs_still_raise,
                       _discover_variants_match_the_cpu])
