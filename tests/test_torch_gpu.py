"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

Inputs are bf16 on both sides; the kernels and the plain versions both sum in
f32, so they differ only in summation order: tolerance 1e-4 of the
reference's scale. Neighbor maps must be equal.
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
