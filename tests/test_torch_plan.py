"""PyTorch port vs JAX package: coordinates, sorted-unique, joins and the UNet
plan. Integer outputs must match bit for bit.

The port's maps here are its plain (CPU) versions: the k^3 map wrapper takes
the join path for tensors on the CPU. They are held against the JAX join path
and against the JAX Pallas map kernel in interpret mode.
"""

import hashlib

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
from gcdlss_tpu_torch.utils.adversarial import neighbor_map_levels

CAPS = (2048, 1536, 1024, 512, 512)


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


def _unique_perm_coords(seed, n=2048, span=14, nbatch=3, fill=0.8):
    """Duplicate-free (b, x, y, z) rows in random order, invalid rows mixed in."""
    coords, valid = _level_coords(seed, cap=n, span=span, nbatch=nbatch)
    valid &= np.arange(n) < int(n * fill)
    perm = np.random.default_rng(seed + 100).permutation(n)
    return coords[perm], valid[perm]


def test_sorted_unique_nodup_matches_jax():
    coords, valid = _unique_perm_coords(11)
    jh, jl = jc.encode_coords(jnp.asarray(coords), jnp.asarray(valid))
    th, tl = tc.encode_coords(torch.as_tensor(coords), torch.as_tensor(valid))
    j = jc.sorted_unique_nodup(jh, jl, coords.shape[0])
    t = tc.sorted_unique_nodup(th, tl, coords.shape[0])
    for a, b in ((j[0][0], t[0][0]), (j[0][1], t[0][1]), (j[1], t[1]), (j[2], t[2]),
                 (j[3], t[3])):
        _eq(a, b)
    with pytest.raises(ValueError):
        tc.sorted_unique_nodup(th, tl, coords.shape[0] - 1)


def test_build_unet_plan_assume_unique_matches_jax():
    coords, valid = _unique_perm_coords(12, span=16, nbatch=2)
    ref = jax.jit(jp.build_unet_plan, static_argnames=("caps", "assume_unique"))(
        jnp.asarray(coords), jnp.asarray(valid), caps=CAPS, assume_unique=True)
    got = tp.build_unet_plan(torch.as_tensor(coords), torch.as_tensor(valid), CAPS,
                             assume_unique=True)
    _eq(ref.stem_nbr, got.stem_nbr)
    _eq(ref.rep, got.rep)
    _eq(ref.inverse, got.inverse)
    for jl, tl in zip(ref.levels, got.levels):
        for f in ("coords", "valid", "count", "nbr3", "key_hi", "key_lo"):
            _eq(getattr(jl, f), getattr(tl, f))
    for jpo, tpo in zip(ref.pools, got.pools):
        for f in ("parent", "dcode", "children", "upmap"):
            _eq(getattr(jpo, f), getattr(tpo, f))


def _edge_level(seed, cap=2048):
    """A level whose voxels touch every face of the coordinate field (where
    the arithmetic column queries leave it) plus a dense blob, three batches."""
    rng = np.random.default_rng(seed)
    e = (1 << 14) - 1
    pts = rng.integers(-12, 12, size=(1500, 3))
    face = rng.integers(-3, 3, size=(300, 3))
    face[:, 0] = rng.choice([-e - 1, -e, e - 1, e], 300)
    face2 = rng.integers(-3, 3, size=(300, 3))
    face2[:, 1] = rng.choice([-e - 1, -e, e - 1, e], 300)
    xyz = np.concatenate([pts, face, face2])
    b = rng.integers(0, 3, size=(xyz.shape[0], 1))
    c = np.unique(np.concatenate([b, xyz], 1), axis=0)[: int(cap * 0.85)].astype(np.int32)
    coords = np.zeros((cap, 4), np.int32)
    coords[: len(c)] = c
    return coords, np.arange(cap) < len(c)


@pytest.mark.parametrize("k1", [3, 5])
def test_sorted_rank_match_and_column_ranks_match_jax(k1):
    """p equals JAX's everywhere (sentinel queries included), has too, on
    arithmetic queries that leave the field at its edges."""
    coords, valid = _edge_level(13)
    uh, ul = _jax_keys(coords, valid)
    lvalid = uh != jc.SENTINEL_HI
    jp_, jhas = jax.jit(jp._column_ranks, static_argnums=3)(lvalid, uh, ul, k1)
    th, tl = torch.tensor(np.asarray(uh)), torch.tensor(np.asarray(ul))
    tp_, thas = tp._column_ranks(th != tc.SENTINEL_HI, th, tl, k1)
    assert tp_.shape == (k1 * k1 - 1, CAPS[0])
    _eq(jp_, tp_)
    _eq(jhas, thas)
    assert bool(thas.any()) and not bool(thas.all())
    # shifted valid keys, some lo words past the 2^30 clamp, and sentinels
    rng = np.random.default_rng(14)
    rows = rng.integers(0, int(np.asarray(lvalid).sum()), 3000)
    qh = np.asarray(uh)[rows] + rng.integers(-1, 2, 3000)
    ql = np.asarray(ul)[rows] + rng.integers(-70000, 70000, 3000)
    ql[:50] = (1 << 30) + rng.integers(0, 1000, 50)
    qh[50:80] = ql[50:80] = jc.SENTINEL_HI
    qh, ql = qh.astype(np.int32), ql.astype(np.int32)
    jr = jax.jit(jj.sorted_rank_match, static_argnums=4)(uh, ul, jnp.asarray(qh),
                                                         jnp.asarray(ql), 2)
    tr = tj.sorted_rank_match(th, tl, torch.as_tensor(qh), torch.as_tensor(ql), 2)
    _eq(jr[0], tr[0])
    _eq(jr[1], tr[1])


def test_cube_candidates_plain_matches_jax_v1_kernel():
    """K4's plain version against the TPU v1 kernel (rank join + Pallas
    candidates + far-pair repair) in interpret mode, k = 3, on the
    distribution of the JAX package's own v1 test."""
    rng = np.random.default_rng(23)
    cap = 2048
    pts = rng.integers(-14, 14, size=(2600, 3)).astype(np.int32)
    b = rng.integers(0, 3, size=(2600, 1)).astype(np.int32)
    c = np.unique(np.concatenate([b, pts], 1), axis=0)[: int(cap * 0.9)]
    coords = np.zeros((cap, 4), np.int32)
    coords[: len(c)] = c
    valid = np.arange(cap) < len(c)
    uh, ul = _jax_keys(coords, valid)
    lvalid = uh != jc.SENTINEL_HI
    lcoords = jnp.where(lvalid[:, None], jc.decode_keys(uh, ul), 0)
    ref = jp._build_cube_kernel_map(lcoords, lvalid, uh, ul, 3, interpret=True, version=1)
    th, tl = torch.tensor(np.asarray(uh)), torch.tensor(np.asarray(ul))
    p, has = tp._column_ranks(th != tc.SENTINEL_HI, th, tl, 3)
    before = tpk.cube_candidates_map.launches
    got = tpk.cube_candidates_map(th, tl, p, has, 3)
    assert tpk.cube_candidates_map.launches == before  # CPU tensors: plain version
    _eq(ref, got)
    _eq(ref, tp.join_neighbor_map(th, tl, 3))


@pytest.mark.parametrize("k1", [3, 5])
def test_cube_candidates_plain_matches_jax_at_field_edge(k1):
    """Where the arithmetic queries leave the field they differ from the
    join's clipped ones; there the reference is the JAX package's column
    build, which resolves the same arithmetic queries as v1."""
    coords, valid = _edge_level(15)
    uh, ul = _jax_keys(coords, valid)
    lvalid = uh != jc.SENTINEL_HI
    lcoords = jnp.where(lvalid[:, None], jc.decode_keys(uh, ul), 0)
    ref = jp._build_cube_neighbor_map(lcoords, lvalid, uh, ul, k1)
    th, tl = torch.tensor(np.asarray(uh)), torch.tensor(np.asarray(ul))
    got = tp.neighbor_map(th, tl, k1, plan_kernel=1)
    _eq(ref, got)
    assert not torch.equal(got, tp.join_neighbor_map(th, tl, k1))


def test_build_unet_plan_plan_kernel_1_matches_jax():
    coords, valid = _level_coords(5, span=16, nbatch=2)
    ref = jax.jit(jp.build_unet_plan, static_argnames=("caps", "presorted"))(
        jnp.asarray(coords), jnp.asarray(valid), caps=CAPS, presorted=True)
    got = tp.build_unet_plan(torch.as_tensor(coords), torch.as_tensor(valid), CAPS,
                             presorted=True, plan_kernel=1)
    _eq(ref.stem_nbr, got.stem_nbr)
    for jl, tl in zip(ref.levels, got.levels):
        _eq(jl.nbr3, tl.nbr3)
    for bad in (0, 3, "1"):
        with pytest.raises(ValueError):
            tp.build_unet_plan(torch.as_tensor(coords), torch.as_tensor(valid), CAPS,
                               presorted=True, plan_kernel=bad)


# ---- levels no scan makes (`utils.adversarial.neighbor_map_levels`)

LEVELS = neighbor_map_levels()


def _level_keys(name):
    """Sorted unique sentinel-padded keys of an adversarial level, by the JAX
    package and by the port (held equal here)."""
    coords, cap = LEVELS[name]
    valid = np.ones(len(coords), bool)
    jh, jl = jc.encode_coords(jnp.asarray(coords.reshape(-1, 4)), jnp.asarray(valid))
    (uh, ul), _, _, _ = jc.sorted_unique(jh, jl, cap)
    th, tl = tc.encode_coords(torch.as_tensor(coords.reshape(-1, 4)), torch.as_tensor(valid))
    (kh, kl), _, _, _ = tc.sorted_unique(th, tl, cap)
    for what, j, t in (("hi", uh, kh), ("lo", ul, kl)):
        rows = np.flatnonzero(np.asarray(j) != t.numpy())
        assert not rows.size, f"{name}: sorted unique keys ({what}) differ at rows {rows[:16].tolist()}"
    return uh, ul, kh, kl


@pytest.mark.parametrize("k1", [3, 5])
@pytest.mark.parametrize("name", sorted(LEVELS))
def test_join_neighbor_map_matches_jax_on_adversarial_levels(name, k1):
    """K3's plain version against the JAX package's map on voxels at the
    field's faces and corners, an empty level, one voxel, a full cube, long z
    runs, four equal batches and a level cut at its capacity."""
    uh, ul, kh, kl = _level_keys(name)
    lvalid = uh != jc.SENTINEL_HI
    lcoords = jnp.where(lvalid[:, None], jc.decode_keys(uh, ul), 0)
    ref = np.asarray(jp.build_neighbor_map(lcoords, lvalid, uh, ul, jp._offsets(k1)))
    got = tp.join_neighbor_map(kh, kl, k1)
    assert got.shape == (LEVELS[name][1], k1 ** 3) and got.dtype == torch.int32
    maps = {"join_neighbor_map": got.numpy(),
            "cube_neighbor_map": tpk.cube_neighbor_map(kh, kl, k1).numpy()}  # the wrapper
    assert all(np.array_equal(ref, m) for m in maps.values()), _map_report(ref, maps)


def _map_report(ref, maps):
    """Which of the port's maps differ from the JAX map, at which rows, and
    whether the port's two maps agree with each other (then the JAX side is
    the suspect)."""
    lines = []
    for what, m in maps.items():
        rows = np.flatnonzero((m != ref).any(axis=1))
        if rows.size:
            r = rows[0]
            lines.append(f"{what} differs from the JAX map at {rows.size} rows {rows[:16].tolist()};"
                         f" row {r}: JAX {ref[r].tolist()}, port {m[r].tolist()}")
    (a, b) = maps.values()
    lines.append("the port's two maps agree" if np.array_equal(a, b) else
                 f"the port's two maps differ at rows {np.flatnonzero((a != b).any(axis=1))[:16].tolist()}")
    return "; ".join(lines)


@pytest.mark.parametrize("k1", [3, 5])
@pytest.mark.parametrize("name", sorted(LEVELS))
def test_cube_direct_rule_equals_join_map(name, k1):
    """The rule the CUDA map kernel computes each row by, whole and without a
    transpose (rows inside the field: the row of key + offset at every offset
    of both halves; rows at its faces: the clipped query below the center,
    the largest row whose clipped query lands here above it), gives the join
    map bit for bit, the folds at the field's edge included."""
    _, _, kh, kl = _level_keys(name)
    got = tpk.cube_direct_rule(kh, kl, k1)
    want = tp.join_neighbor_map(kh, kl, k1)
    assert torch.equal(got, want)
    if name == "field_edge":  # the folds are there: some row above the center maps to itself
        half = k1 ** 3 // 2
        rows = torch.arange(kh.shape[0], dtype=torch.int32)[:, None]
        assert bool((want[:, half + 1:] == rows).any())
    if name == "dense_cube":  # an inner voxel of the full cube has every neighbour
        assert bool((want >= 0).all(dim=1).any())


@pytest.mark.parametrize("k1", [3, 5])
@pytest.mark.parametrize("name", sorted(LEVELS))
def test_column_queries_of_consecutive_rows_have_nondecreasing_ranks(name, k1):
    """What lets a block of the map kernel search a short range: among the
    rows whose coordinates lie k1 // 2 or more inside the field, the query of
    one (dx, dy) column is key + constant, so its insertion rank does not
    decrease with the row, and every match of the column lies in the k1
    table rows from that rank on."""
    _, _, kh, kl = _level_keys(name)
    r = k1 // 2
    keys = tc.pack_keys(kh, kl)
    x, y, z = kh % tc.FIELD, kl // tc.FIELD, kl % tc.FIELD
    lo_c = torch.minimum(x, torch.minimum(y, z))
    hi_c = torch.maximum(x, torch.maximum(y, z))
    fast = (kh != tc.SENTINEL_HI) & (lo_c >= r) & (hi_c <= tc.FIELD - 1 - r)
    want = tp.join_neighbor_map(kh, kl, k1)
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            q0 = keys[fast] + ((dx << 32) + dy * tc.FIELD - r)
            rank = torch.searchsorted(keys, q0)
            assert bool((rank[1:] >= rank[:-1]).all())
            col = ((dx + r) * k1 + (dy + r)) * k1
            hit = want[fast][:, col:col + k1]
            present = hit >= 0
            lo = rank[:, None].expand_as(hit)[present]
            assert bool(((hit[present] >= lo) & (hit[present] < lo + k1)).all())


@pytest.mark.parametrize("name", ["dense_cube", "z_runs", "four_batches", "over_capacity",
                                  "one_voxel", "all_sentinel"])
def test_cube_candidates_plain_equals_join_map_inside_the_field(name):
    """K4's plain version on the column ranks gives the join map wherever no
    voxel touches the field's faces (there its arithmetic queries differ)."""
    _, _, kh, kl = _level_keys(name)
    for k1 in (3, 5):
        p, has = tp._column_ranks(kh != tc.SENTINEL_HI, kh, kl, k1)
        assert torch.equal(tpk.cube_candidates_plain(kh, kl, p, has, k1),
                           tp.join_neighbor_map(kh, kl, k1))


# sha256 (first 32 hex digits) of the int32 map and its present entries, as
# the JAX package's column build `plan._build_cube_neighbor_map` gives it on
# each level of `neighbor_map_levels()` (seed 13): the arithmetic queries of
# its v1 route, whose Pallas kernel needs a cap that is a multiple of its
# block and is v1's exact fallback everywhere else. Frozen because building
# the fourteen maps in JAX costs over a minute on the CPU; `_jax_v1_digest`
# rebuilds one (`test_cube_candidates_golden_is_the_jax_column_build`) or,
# called over the keys, all of them.
V1_GOLDENS = {
    ("field_edge", 3): ("a41d00ecf99c2ea54d5c6b9ff9f579fa", 6640),
    ("field_edge", 5): ("53426f5b4b4478f95de586069f824b9d", 17538),
    ("all_sentinel", 3): ("682a387ec62c4338e6ba238c81587700", 0),
    ("all_sentinel", 5): ("b97473e7fefd7d30cea5662a3bbe6a06", 0),
    ("one_voxel", 3): ("3f1063a562a2198895cf3fdd8e669607", 1),
    ("one_voxel", 5): ("96b0f905828411084a5809e4ffada052", 1),
    ("dense_cube", 3): ("f76acee28c9de817e9232368a3047019", 39304),
    ("dense_cube", 5): ("ad5c2a85a198859f5049239efd754ff7", 157464),
    ("z_runs", 3): ("b7dd73d58c4fb48b092349c76b07d180", 3950),
    ("z_runs", 5): ("47d15ec5d9c29b3990d36238b172b37f", 5936),
    ("four_batches", 3): ("2aad5110c50769b5e70ec57988ff5b19", 5536),
    ("four_batches", 5): ("d4fb27566e64d9227634744c663d4d18", 17696),
    ("over_capacity", 3): ("43b9503a052aeab9a40423e4d4d8255f", 7730),
    ("over_capacity", 5): ("d8ddce7bd73c9c0967bcb2c2eaecabed", 29550),
}


def _digest(nbr) -> tuple:
    a = np.ascontiguousarray(np.asarray(nbr), dtype=np.int32)
    return hashlib.sha256(a.tobytes()).hexdigest()[:32], int((a >= 0).sum())


@pytest.mark.parametrize("name,k1", sorted(V1_GOLDENS))
def test_cube_candidates_plain_matches_jax_v1_goldens(name, k1):
    """K4's plain version on the port's column ranks, on the levels no scan
    makes (the field's faces and corners, no voxel, one voxel, a full cube,
    z runs, equal batches, a level cut at its capacity), gives the JAX
    package's v1 map bit for bit; through the wrapper on CPU tensors too."""
    _, _, kh, kl = _level_keys(name)
    p, has = tp._column_ranks(kh != tc.SENTINEL_HI, kh, kl, k1)
    got = tpk.cube_candidates_plain(kh, kl, p, has, k1)
    assert got.shape == (LEVELS[name][1], k1 ** 3) and got.dtype == torch.int32
    assert _digest(got) == V1_GOLDENS[name, k1]
    assert torch.equal(tpk.cube_candidates_map(kh, kl, p, has, k1), got)


def _jax_v1_digest(name: str, k1: int) -> tuple:
    """The digest of the JAX package's map of one level (a `V1_GOLDENS` entry)."""
    uh, ul, _, _ = _level_keys(name)
    lvalid = uh != jc.SENTINEL_HI
    lcoords = jnp.where(lvalid[:, None], jc.decode_keys(uh, ul), 0)
    return _digest(jp._build_cube_neighbor_map(lcoords, lvalid, uh, ul, k1))


def test_cube_candidates_golden_is_the_jax_column_build():
    """One golden rebuilt from the JAX package: the level where the
    arithmetic queries leave the field."""
    assert _jax_v1_digest("field_edge", 5) == V1_GOLDENS["field_edge", 5]


@pytest.mark.parametrize("k1", [3, 5])
@pytest.mark.parametrize("name", sorted(LEVELS))
def test_cube_candidates_equals_k3_off_the_field_faces(name, k1):
    """The check the card runs on K4 (`chip_smoke.check_cube_candidates_level`),
    here on the plain versions: K4 equals its plain version and, on every row
    but those within k1 // 2 of the field's faces, K3's map."""
    import chip_smoke

    chip_smoke.check_cube_candidates_level(torch.device("cpu"), name, k1)


def test_cube_neighbor_map_refuses_what_the_kernel_does_not_serve():
    """The checks ahead of the launch, on a device without a kernel."""
    kh = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tpk.cube_neighbor_map(kh, kh, 3)  # neither the CPU nor a CUDA device
    assert tpk.CUBE_MAP_MAX_K1 == 21
