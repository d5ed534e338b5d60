"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

Inputs are bf16 on both sides; the kernels and the plain versions both sum in
f32, so they differ only in summation order: tolerance 1e-4 of the
reference's scale. Neighbor maps must be equal. The conv parts (P1-P4) run
every mode of `tools/conv_parts.py` at small and at its full-width shapes,
with that tool's tolerances.
"""

import numpy as np
import pytest
import torch

from gcdlss_tpu_torch.ops import conv as plain
from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
from gcdlss_tpu_torch.ops.coords import SENTINEL_HI
from gcdlss_tpu_torch.ops.plan import _column_ranks, build_unet_plan, join_neighbor_map
from gcdlss_tpu_torch.ops.plan_kernel import (cube_candidates_map, cube_candidates_plain,
                                              cube_neighbor_map)

pytestmark = pytest.mark.gpu
CAPS = (4096, 2048, 1024, 512, 256)


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


@pytest.mark.parametrize("ci,co,kind", [(1, 32, "stem"), (192, 96, "k3"), (32, 32, "down"),
                                        (64, 48, "up")])
def test_gather_gemm_matches_plain(plan, ci, co, kind):
    if kind == "stem":
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


def test_wrappers_reject_wrong_inputs(plan):
    nbr = plan.levels[1].nbr3
    x = torch.zeros(nbr.shape[0], 8, device=nbr.device, dtype=torch.bfloat16)
    w = torch.zeros(27, 8, 4, device=nbr.device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        gather_gemm(x.float(), nbr, w)
    with pytest.raises(ValueError):
        gather_gemm(x, nbr, w[:, :4])
    with pytest.raises(ValueError):
        gather_gemm(x.t(), nbr, w)


@pytest.mark.parametrize("lvl,k1", [(0, 5), (0, 3), (1, 3), (3, 3)])
def test_cube_map_matches_join(plan, lvl, k1):
    kh, kl = plan.levels[lvl].key_hi, plan.levels[lvl].key_lo
    assert torch.equal(cube_neighbor_map(kh, kl, k1), join_neighbor_map(kh, kl, k1))


@pytest.mark.parametrize("lvl,k1", [(0, 5), (0, 3), (1, 3), (3, 3)])
def test_cube_candidates_matches_plain_and_k3(plan, lvl, k1):
    kh, kl = plan.levels[lvl].key_hi, plan.levels[lvl].key_lo
    p, has = _column_ranks(kh != SENTINEL_HI, kh, kl, k1)
    before = cube_candidates_map.launches
    got = cube_candidates_map(kh, kl, p, has, k1)
    assert cube_candidates_map.launches == before + 1
    assert torch.equal(got, cube_candidates_plain(kh, kl, p, has, k1))
    assert torch.equal(got, cube_neighbor_map(kh, kl, k1))


def test_plan_kernel_1_builds_the_same_plan(plan):
    lv0 = plan.levels[0]
    other = build_unet_plan(lv0.coords, lv0.valid, CAPS, plan_kernel=1)
    assert torch.equal(other.stem_nbr, plan.stem_nbr)
    for a, b in zip(other.levels, plan.levels):
        assert torch.equal(a.nbr3, b.nbr3)


def test_cube_candidates_rejects_wrong_inputs(plan):
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


@pytest.fixture(scope="module", params=PART_SHAPES, ids=lambda s: f"N{s[0]}-C{s[1]}")
def parts(request):
    """(x, w, nbr) on the card at one of the tool's shapes, and every mode
    of the tool's table on them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gcdlss_tpu_torch.tools import conv_parts as tool

    rows, c, voxel = request.param
    dev = torch.device("cuda")
    nbr, valid, _ = tool.level0_book(rows, voxel, 0, dev)
    g = torch.Generator(device="cuda").manual_seed(c)
    x = (torch.randn(rows, c, device=dev, generator=g) * valid[:, None]).bfloat16()
    w = torch.randn(27, c, c, device=dev, generator=g).mul((2.0 / (27 * c)) ** 0.5).bfloat16()
    return x, w, nbr, tool.modes(x, w, nbr, rows, c), tool.TOL


def test_conv_parts_match_plain_in_every_mode(parts):
    """Every mode of P1-P4 (layouts, windows, buffers, window starts; index
    modes rolled and unrolled; product; one-hot) against its plain version:
    P1 1e-3, P2 1e-5, P3 and P4 1e-2 of the reference's scale, index_only
    exact."""
    from gcdlss_tpu_torch.ops import conv_parts as cp

    x, w, nbr, modes, tol = parts
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


def test_onehot_conv_far_entries(parts):
    """P4 on a book whose entries mostly lie outside their sub-windows (a
    random book) is still the conv, and counts those entries as the plain
    rule does."""
    from gcdlss_tpu_torch.ops import conv_parts as cp

    x, w, nbr, _, tol = parts
    g = torch.Generator(device="cuda").manual_seed(1)
    rnd = torch.randint(-1, x.shape[0], nbr.shape, device=x.device, generator=g,
                        dtype=torch.int32)
    for book in (nbr, rnd):
        out, far = cp.onehot_conv(x, book, w)
        ref = plain.gather_conv(x, book, w)
        torch.testing.assert_close(out, ref, rtol=0, atol=tol["P4"] * float(ref.abs().max()))
        assert int(far) == int(cp.onehot_far_plain(book))
    assert int(far) > 0.8 * int((rnd >= 0).sum())


def test_window_sum_unaligned_starts(parts):
    """Window starts that are no multiple of 8: the column layouts stage
    those runs element by element."""
    from gcdlss_tpu_torch.ops import conv_parts as cp

    x, _, _, _, tol = parts
    n = x.shape[0]
    ws = (torch.arange(n // 256, dtype=torch.int32, device=x.device) * 251 + 3).clamp(max=n - 2048)
    for layout in cp.LAYOUTS:
        held = cp.to_layout(x, layout)
        for buffers in (1, 2):
            got = cp.window_sum(held, ws, 2048, layout, buffers)
            ref = cp.window_sum_plain(held, ws, 2048, layout)
            torch.testing.assert_close(got, ref, rtol=0, atol=tol["P1"] * float(ref.abs().max()))


def test_conv_parts_reject_wrong_inputs(parts):
    from gcdlss_tpu_torch.ops import conv_parts as cp

    x, w, nbr, _, _ = parts
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
