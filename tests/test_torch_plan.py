"""PyTorch port vs JAX package: coordinates, sorted-unique, joins and the UNet
plan. Integer outputs must match bit for bit.

The port's maps here are its plain (CPU) versions: the k^3 map wrapper takes
the join path for tensors on the CPU. They are held against the JAX join path
and against the JAX Pallas map kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcdlss_tpu.ops import coords as jc
from gcdlss_tpu.ops import join as jj
from gcdlss_tpu.ops import plan as jp
from gcdlss_tpu_torch.ops import coords as tc
from gcdlss_tpu_torch.ops import join as tj
from gcdlss_tpu_torch.ops import plan as tp
from gcdlss_tpu_torch.ops import plan_kernel as tpk

CAPS = (2048, 1536, 1024, 512, 512)


def _rand_coords(rng, n, lo=-50, hi=50, nbatch=2):
    c = rng.integers(lo, hi, size=(n, 3))
    b = rng.integers(0, nbatch, size=(n, 1))
    return np.hstack([b, c]).astype(np.int32)


def _level_coords(seed, cap=2048, span=14, nbatch=3):
    """Sorted unique (b, x, y, z) rows filling 90% of cap, invalid tail."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(-span, span, size=(int(cap * 1.3), 3))
    b = rng.integers(0, nbatch, size=(pts.shape[0], 1))
    c = np.unique(np.concatenate([b, pts], 1), axis=0)[: int(cap * 0.9)].astype(np.int32)
    coords = np.zeros((cap, 4), np.int32)
    coords[: len(c)] = c
    valid = np.zeros(cap, bool)
    valid[: len(c)] = True
    return coords, valid


def _jax_keys(coords, valid):
    hi, lo = jc.encode_coords(jnp.asarray(coords), jnp.asarray(valid))
    (uh, ul), _, _, _ = jc.sorted_unique(hi, lo, coords.shape[0])
    return uh, ul


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy())


def test_encode_decode_matches_jax():
    rng = np.random.default_rng(0)
    coords = _rand_coords(rng, 300)
    coords[:5, 1:] = [[20000, -20000, 0], [16383, 0, -16384], [-16385, 5, 5],
                      [0, 16384, 3], [7, 7, -7]]  # clipped at the field edge
    valid = rng.random(300) < 0.9
    jh, jl = jc.encode_coords(jnp.asarray(coords), jnp.asarray(valid))
    th, tl = tc.encode_coords(torch.as_tensor(coords), torch.as_tensor(valid))
    _eq(jh, th)
    _eq(jl, tl)
    _eq(jc.decode_keys(jh, jl)[valid], tc.decode_keys(th, tl)[torch.as_tensor(valid)])


@pytest.mark.parametrize("capacity", [500, 37])
def test_sorted_unique_matches_jax(capacity):
    rng = np.random.default_rng(1)
    coords = _rand_coords(rng, 500, lo=-5, hi=5)  # many duplicates
    valid = np.ones(500, bool)
    valid[440:] = False
    jh, jl = jc.encode_coords(jnp.asarray(coords), jnp.asarray(valid))
    th, tl = tc.encode_coords(torch.as_tensor(coords), torch.as_tensor(valid))
    (juh, jul), jrep, jinv, jcnt = jc.sorted_unique(jh, jl, capacity)
    (tuh, tul), trep, tinv, tcnt = tc.sorted_unique(th, tl, capacity)
    for a, b in ((juh, tuh), (jul, tul), (jrep, trep), (jinv, tinv), (jcnt, tcnt)):
        _eq(a, b)
    assert int(tcnt) > capacity or capacity == 500  # count is the true count


@pytest.mark.parametrize("capacity", [2048, 1500])
def test_sorted_unique_presorted_matches_jax(capacity):
    coords, valid = _level_coords(2)
    coords[100] = coords[99]  # an adjacent duplicate
    valid[300:310] = False  # invalid rows mid-stream
    jh, jl = jc.encode_coords(jnp.asarray(coords), jnp.asarray(valid))
    th, tl = tc.encode_coords(torch.as_tensor(coords), torch.as_tensor(valid))
    j = jc.sorted_unique_presorted(jh, jl, capacity)
    t = tc.sorted_unique_presorted(th, tl, capacity)
    for a, b in ((j[0][0], t[0][0]), (j[0][1], t[0][1]), (j[1], t[1]), (j[2], t[2]),
                 (j[3], t[3])):
        _eq(a, b)


def test_sorted_join_and_rank_match_jax():
    rng = np.random.default_rng(3)
    coords, valid = _level_coords(3)
    uh, ul = _jax_keys(coords, valid)
    q = _rand_coords(rng, 4000, lo=-16, hi=16, nbatch=4)
    qv = rng.random(4000) < 0.95
    qh, ql = jc.encode_coords(jnp.asarray(q), jnp.asarray(qv))
    t = [torch.tensor(np.asarray(a)) for a in (uh, ul, qh, ql)]
    _eq(jj.sorted_join(uh, ul, qh, ql), tj.sorted_join(*t))
    _eq(jj.sorted_rank(uh, ul, qh, ql), tj.sorted_rank(*t))


@pytest.mark.parametrize("k1", [3, 5])
def test_neighbor_map_matches_jax_join(k1):
    coords, valid = _level_coords(4)
    uh, ul = _jax_keys(coords, valid)
    lvalid = uh != jc.SENTINEL_HI
    lcoords = jnp.where(lvalid[:, None], jc.decode_keys(uh, ul), 0)
    ref = jp.build_neighbor_map(lcoords, lvalid, uh, ul, jp._offsets(k1))
    th, tl = torch.tensor(np.asarray(uh)), torch.tensor(np.asarray(ul))
    before = tpk.cube_neighbor_map.launches
    _eq(ref, tpk.cube_neighbor_map(th, tl, k1))
    assert tpk.cube_neighbor_map.launches == before  # CPU tensors: plain version
    # the join path without the transpose: every offset joined directly
    full = jp._join_offsets(lcoords, lvalid, uh, ul, jp._offsets(k1), 32)
    _eq(full, tp.join_neighbor_map(th, tl, k1))


def test_neighbor_map_matches_jax_map_kernel():
    """Against the TPU k^3 map kernel (v2) in interpret mode, k = 3."""
    coords, valid = _level_coords(29, span=12)
    uh, ul = _jax_keys(coords, valid)
    lvalid = uh != jc.SENTINEL_HI
    lcoords = jnp.where(lvalid[:, None], jc.decode_keys(uh, ul), 0)
    ref = jp._build_cube_kernel_map(lcoords, lvalid, uh, ul, 3, interpret=True, version=2)
    got = tpk.cube_neighbor_map(torch.tensor(np.asarray(uh)),
                                torch.tensor(np.asarray(ul)), 3)
    _eq(ref, got)


@pytest.mark.parametrize("presorted", [True, False])
def test_build_unet_plan_matches_jax(presorted):
    coords, valid = _level_coords(5, span=16, nbatch=2)
    if not presorted:
        perm = np.random.default_rng(6).permutation(coords.shape[0])
        coords, valid = coords[perm], valid[perm]
    ref = jax.jit(jp.build_unet_plan, static_argnames=("caps", "presorted"))(
        jnp.asarray(coords), jnp.asarray(valid), caps=CAPS, presorted=presorted)
    got = tp.build_unet_plan(torch.as_tensor(coords), torch.as_tensor(valid), CAPS,
                             presorted=presorted)
    _eq(ref.stem_nbr, got.stem_nbr)
    _eq(ref.rep, got.rep)
    _eq(ref.inverse, got.inverse)
    for jl, tl in zip(ref.levels, got.levels):
        for f in ("coords", "valid", "count", "nbr3", "key_hi", "key_lo"):
            _eq(getattr(jl, f), getattr(tl, f))
    for jpo, tpo in zip(ref.pools, got.pools):
        for f in ("parent", "dcode", "children", "upmap"):
            _eq(getattr(jpo, f), getattr(tpo, f))
    _eq(jp.plan_capacity_overflow(ref), tp.plan_capacity_overflow(got))


def test_plan_capacity_overflow_matches_jax():
    coords, valid = _level_coords(7, span=30, nbatch=2)
    caps = (2048, 1024, 512, 256, 256)  # too small: levels drop voxels
    ref = jax.jit(jp.build_unet_plan, static_argnames=("caps", "presorted"))(
        jnp.asarray(coords), jnp.asarray(valid), caps=caps, presorted=True)
    got = tp.build_unet_plan(torch.as_tensor(coords), torch.as_tensor(valid), caps,
                             presorted=True)
    assert int(tp.plan_capacity_overflow(got)) > 0
    _eq(jp.plan_capacity_overflow(ref), tp.plan_capacity_overflow(got))
    for jpo, tpo in zip(ref.pools, got.pools):
        _eq(jpo.children, tpo.children)
        _eq(jpo.upmap, tpo.upmap)
