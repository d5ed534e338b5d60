"""Inputs that the training plans never make, for holding the kernels to
their plain versions: voxel levels for the k^3 neighbor map and shapes for the
dense shifted-row product. numpy only; the CPU tests, the tests on the card
and `chip_smoke.py` all take them from here."""

from __future__ import annotations

import numpy as np

FIELD_EDGE = (1 << 14) - 1  # the largest coordinate the packed keys hold; the smallest is -FIELD_EDGE - 1


def neighbor_map_levels(seed: int = 13) -> dict:
    """name -> (coords [n, 4] int32 (b, x, y, z), not sorted, cap). No cap
    but one is a multiple of 128 (the rows a block of the map kernel owns)."""
    rng = np.random.default_rng(seed)
    e = FIELD_EDGE
    levels = {}

    # voxels on every face, edge and corner of the coordinate field, where
    # `encode_coords`' clip folds neighbouring queries onto one voxel, plus a blob
    parts = [rng.integers(-12, 12, size=(1500, 3))]
    for axes in ((0,), (1,), (2,), (0, 1), (1, 2), (0, 1, 2)):
        face = rng.integers(-3, 3, size=(160, 3))
        for a in axes:
            face[:, a] = rng.choice([-e - 1, -e, -e + 1, e - 2, e - 1, e], 160)
        parts.append(face)
    xyz = np.concatenate(parts)
    levels["field_edge"] = (_with_batch(rng, xyz, 3), 2509)

    levels["all_sentinel"] = (np.zeros((0, 4), np.int32), 300)
    levels["one_voxel"] = (np.array([[1, 5, -7, 3]], np.int32), 130)

    g = np.arange(-6, 6)
    cube = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    levels["dense_cube"] = (_with_batch(rng, cube, 1), len(cube) + 3)  # every neighbour present

    cols = rng.integers(-40, 40, size=(10, 2))
    runs = np.concatenate([np.column_stack([np.full(200, x), np.full(200, y), np.arange(-100, 100)])
                           for x, y in cols])
    levels["z_runs"] = (_with_batch(rng, runs, 2), 4100)

    same = rng.integers(-9, 9, size=(500, 3))
    levels["four_batches"] = (np.concatenate(
        [np.column_stack([np.full(len(same), b), same]) for b in range(4)]).astype(np.int32), 2100)

    # more voxels than rows: the level is cut at its capacity
    levels["over_capacity"] = (_with_batch(rng, rng.integers(-8, 8, size=(3000, 3)), 2), 1000)
    return levels


def _with_batch(rng, xyz: np.ndarray, nbatch: int) -> np.ndarray:
    b = rng.integers(0, nbatch, size=(len(xyz), 1))
    return np.concatenate([b, xyz], 1).astype(np.int32)


# (N, K, Ci, Co) of the shifted-row product: N = 1 and around a block's 128 and
# 256 rows, K odd, even and 1, Ci from one 16-byte piece to the widest layer,
# Co not a multiple of 8, one and two column tiles
TILE_GEMM_SHAPES = (
    (1, 27, 8, 20), (127, 2, 24, 96), (129, 8, 96, 256), (4097, 27, 256, 20),
    (1, 1, 96, 96), (127, 27, 96, 96), (129, 1, 256, 256), (4097, 8, 24, 256),
    (4097, 2, 8, 96), (129, 27, 24, 20), (127, 8, 256, 96), (4097, 27, 96, 256),
)


# (N_out, N_in, K, C, book) of the gather without the product (`book` kinds
# below): N_out 1, 127, 129 and 4,097 (no multiple of a block's rows), C from
# one 16-byte piece to 256, K 1, 8 and 27, N_in != N_out
GATHER_SUM_CASES = (
    (1, 1, 27, 8, "random"), (127, 300, 8, 24, "random"), (129, 129, 1, 96, "full"),
    (4097, 4097, 27, 256, "random"), (4097, 4097, 27, 96, "absent"),
    (4097, 2000, 27, 96, "full"), (129, 50, 27, 256, "last_row"), (127, 127, 27, 8, "last_row"),
    (4096, 4096, 8, 256, "random"), (1, 4097, 1, 96, "random"), (4097, 4097, 27, 24, "full"),
)

# (N_out, N_in, K, Ci, Co, book) of the conv with its gather as a one-hot
# product: the random book (most entries outside every window), no entry, a
# single row, every entry inside one window; Ci 8, 24, 96, 256, Co 20, 96,
# 256; N_in != N_out, N_in smaller than a window
ONEHOT_CASES = (
    (4097, 4097, 27, 96, 96, "random"), (3000, 5000, 27, 256, 256, "random"),
    (5000, 3000, 8, 8, 20, "random"), (4097, 4097, 27, 96, 256, "absent"),
    (1, 300, 27, 96, 96, "random"), (1, 1, 27, 8, 20, "full"),
    (2000, 2000, 27, 256, 96, "one_window"), (1000, 60, 27, 24, 96, "random"),
    (4097, 4097, 27, 8, 256, "one_window"), (129, 129, 27, 256, 20, "last_row"),
)


def book(n_out: int, n_in: int, k: int, kind: str, seed: int = 0) -> np.ndarray:
    """int32 [n_out, k] rows of an x of n_in rows, -1 absent: "random" (each
    entry present with probability 0.3, uniform over x), "full" (every entry
    present), "absent" (none), "last_row" (present entries half of them the
    last row of x), "one_window" (every entry among 100 consecutive rows)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_in, size=(n_out, k))
    if kind == "one_window":
        rows = n_in // 3 + rng.integers(0, min(100, n_in - n_in // 3), size=(n_out, k))
    if kind == "last_row":
        rows = np.where(rng.random((n_out, k)) < 0.5, n_in - 1, rows)
    present = {"random": 0.3, "last_row": 0.5, "full": 1.0, "one_window": 0.4, "absent": 0.0}[kind]
    return np.where(rng.random((n_out, k)) < present, rows, -1).astype(np.int32)


# (N, C, W, NB, starts) of the window staging P1 (`window_starts` kinds
# below): NB no multiple of the 8 windows a cluster takes, equal starts,
# starts at 0 and at N - W, unaligned starts, W = 32, N = W, C 8 and 256, N no
# multiple of 128 (no tiles layout) or of 8 (rows layout only), random
# starts at W 6144 and C 256, whose union no cluster's shared memory holds,
# and more clusters than the card holds at once (two windows a block)
WINDOW_SUM_CASES = (
    (4096, 96, 2048, 13, "sequential"), (4096, 8, 256, 20, "equal"),
    (8192, 256, 1024, 9, "ends"), (4096, 16, 32, 37, "unaligned"),
    (2048, 96, 2048, 5, "sequential"), (16384, 256, 6144, 11, "unaligned"),
    (1000, 24, 96, 8, "unaligned"), (1003, 8, 992, 3, "ends"),
    (65536, 256, 6144, 64, "random"), (65536, 256, 512, 700, "unaligned"),
)


def window_starts(n: int, window: int, nb: int, kind: str, seed: int = 0) -> np.ndarray:
    """int32 [nb] window starts in [0, n - window]: "sequential" (i * 256,
    clamped at n - window), "equal" (one unaligned start for all), "ends"
    (0 and n - window in turn), "unaligned" (uniform), "random" (uniform
    multiples of 8)."""
    rng = np.random.default_rng(seed)
    top = n - window
    if kind == "sequential":
        ws = np.minimum(np.arange(nb) * 256, top)
    elif kind == "equal":
        ws = np.full(nb, min(top, 8 * rng.integers(0, top // 8 + 1) + 3) if top else 0)
    elif kind == "ends":
        ws = np.where(np.arange(nb) % 2 == 0, 0, top)
    elif kind == "unaligned":
        ws = rng.integers(0, top + 1, size=nb)
    elif kind == "random":
        ws = rng.integers(0, top // 8 + 1, size=nb) * 8
    else:
        raise ValueError(f"unknown window starts {kind!r}")
    return ws.astype(np.int32)
