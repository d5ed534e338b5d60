"""The sparse conv taken apart: four component kernels (CUDA,
`csrc/conv_parts.cu`) with their plain versions, for the cost bisection of
K1 (`fused_conv.gather_gemm`) that `tools/conv_parts.py` runs.

They take the place of the TPU package's Pallas diagnostics under `tools/`
(`scaffold_bisect_bench.py`, `kernel_variants_bench.py`, `fori_diag_bench.py`,
`kernel_bisect_bench.py`, `dma_layout_bench.py`). Those compute wrong results
at the right cost; each part here computes a defined function, so that it can
be held to a plain version:

  P1 `window_sum`   staging without arithmetic: the window of `window`
                    source rows at `ws[i]` summed,
                    out[i, c] = sum_{r < window} x[ws[i] + r, c],
                    with each row of a cluster's windows staged once
                    (`window_schedule_plain`)
  P2 `gather_sum`   the gather without the product:
                    out[u, c] = sum_k [nbr[u, k] >= 0] x[nbr[u, k], c]
  P3 `tile_gemm`    the product without the gather, on the tensor cores
                    (`wgmma`), x staged once per block of rows:
                    out[u] = sum_k x[clip(u + k - K // 2, 0, N - 1)] @ W[k]
  P4 `onehot_conv`  the conv itself with the gather done as a product on
                    the tensor cores: per (block of `ONEHOT_ROWS` rows, k)
                    a window of `ONEHOT_SUBWIN` source rows from the block's
                    smallest present entry, G = onehot(rel) @ window with
                    the one-hot built in registers and only the k16 tiles
                    that hold an entry multiplied (`onehot_tiles_plain`),
                    then G @ W[k]; entries outside the window are gathered
                    directly (`onehot_far_plain`), so the result is the
                    conv's for every entry: out[u] = sum_k x[nbr[u, k]] @ W[k]

Activations and weights are bf16, books and window starts int32, sums and
outputs f32. Each wrapper takes its plain version only for tensors on the
CPU. For CUDA tensors it checks device, dtype, shape and contiguity, allocates
the output, launches on the current stream and raises on a non-zero CUDA
error; there is no fallback. Each keeps a plain integer launch count
(`window_sum.launches`).
"""

from __future__ import annotations

import torch

from . import _build
from .conv import _gather_rows, gather_conv
from .fused_conv import _check, _cuda_device

LAYOUTS = ("rows", "cols", "tiles")  # [N, C], [C, N], [N / 128, C, 128]
TILE_ROWS = 128  # rows per tile of the "tiles" layout
STAGE_ROWS = 32  # P1: a window is a multiple of this many rows
WINDOW_CLUSTER = 8  # P1: blocks of a cluster, which stages its windows' union once
MAX_CHANNELS = 256  # P1, P2: one block covers all channels of a row
INDEX_MODES = ("dynamic", "static", "index_only")
ONEHOT_ROWS = 128  # P4: output rows per block (8 strips of 16)
ONEHOT_SUBWIN = 128  # P4: source rows staged per (block, k): 8 k16 tiles
ONEHOT_STRIP = 16  # P4: rows of a strip, and of a k16 tile of the window
ONEHOT_MAX_K = 64  # P4: the block's book slice fits beside the stages


# ---------------------------------------------------------------- layouts

def to_layout(x_rows: torch.Tensor, layout: str) -> torch.Tensor:
    """`x_rows` [N, C] as a contiguous tensor in `layout` (the same values)."""
    n, c = x_rows.shape
    if layout == "rows":
        return x_rows.contiguous()
    if layout == "cols":
        return x_rows.T.contiguous()
    if layout == "tiles":
        if n % TILE_ROWS:
            raise ValueError(f"tiles layout needs N % {TILE_ROWS} == 0, got {n}")
        return x_rows.reshape(n // TILE_ROWS, TILE_ROWS, c).transpose(1, 2).contiguous()
    raise ValueError(f"unknown layout {layout!r}, expected one of {LAYOUTS}")


def from_layout(x: torch.Tensor, layout: str) -> torch.Tensor:
    """The [N, C] view of a tensor held in `layout`."""
    if layout == "rows":
        return x
    if layout == "cols":
        return x.T
    if layout == "tiles":
        return x.transpose(1, 2).reshape(-1, x.shape[1])
    raise ValueError(f"unknown layout {layout!r}, expected one of {LAYOUTS}")


def window_starts(n: int, block: int, window: int, random: bool = False,
                  seed: int = 1, align: int = 1) -> torch.Tensor:
    """Window start per block of `block` rows, int32 on the CPU: sequential
    `min(i * block, n - window)`, or uniform over the multiples of `align`
    in [0, n - window]."""
    nb = n // block
    if random:
        g = torch.Generator().manual_seed(seed)
        return torch.randint(0, (n - window) // align + 1, (nb,), generator=g,
                             dtype=torch.int32) * align
    return (torch.arange(nb, dtype=torch.int32) * block).clamp(max=n - window)


# ---------------------------------------------------------------- P1

def window_sum_plain(x: torch.Tensor, ws: torch.Tensor, window: int,
                     layout: str = "rows") -> torch.Tensor:
    """Plain P1: a difference of two rows of the f64 cumulative sum."""
    rows = from_layout(x, layout).double()
    csum = torch.cat([rows.new_zeros(1, rows.shape[1]), rows.cumsum(0)])
    lo = ws.long()
    return (csum[lo + window] - csum[lo]).float()


def window_schedule_plain(ws, window: int, per_block: int = 1,
                          cluster: int = WINDOW_CLUSTER) -> list:
    """P1's schedule, the rule the kernel stages and adds by, per cluster of
    `cluster` blocks of `per_block` consecutive windows each (the last
    cluster may hold fewer windows). Window i = [s, s + window) splits into a
    head [s, ceil8(s)), a body [ceil8(s), floor8(s + window)) and a tail
    [floor8(s + window), s + window); a window whose body would be empty
    reads all its rows as its head. The bodies' union is a sorted list of
    disjoint 8-aligned intervals of G groups of 8 rows; block b of the cluster stages
    the union's groups [b G // cluster, (b + 1) G // cluster) in order. The
    sorted distinct body starts and ends bound the segments. Window i adds
    its head rows (read from x), then for each segment of its body in order
    the sums of that segment over the blocks whose share meets it, in rank
    order, then its tail rows.

    Returns one dict per cluster: "windows" (their indices), "union" (row
    intervals), "bounds" (segment boundaries), "shares" (per rank, the row
    intervals it stages) and "parts" (per window: "head" and "tail" row
    ranges, "segments": [(row range, ranks whose share meets it)])."""
    ws = [int(s) for s in ws]
    out = []
    span = cluster * per_block
    for c0 in range(0, len(ws), span):
        idx = list(range(c0, min(c0 + span, len(ws))))
        body = {i: (-(-ws[i] // 8) * 8, (ws[i] + window) // 8 * 8) for i in idx}
        live = sorted(b for b in body.values() if b[0] < b[1])
        union = []
        for lo, hi in live:
            if union and lo <= union[-1][1]:
                union[-1][1] = max(union[-1][1], hi)
            else:
                union.append([lo, hi])
        pre = [0]
        for lo, hi in union:
            pre.append(pre[-1] + (hi - lo) // 8)
        gt = pre[-1]

        def rows_of(g0: int, g1: int) -> list:
            """Row intervals of the union's groups [g0, g1)."""
            got = []
            for (lo, _), p0, p1 in zip(union, pre, pre[1:]):
                a, b = max(g0, p0), min(g1, p1)
                if a < b:
                    got.append((lo + (a - p0) * 8, lo + (b - p0) * 8))
            return got

        def group_of(row: int) -> int:
            """Union groups before `row` (a row inside or at the end of an interval)."""
            for (lo, hi), p0 in zip(union, pre):
                if lo <= row <= hi:
                    return p0 + (row - lo) // 8
            raise AssertionError(f"row {row} is in no interval of the union")

        share = [(b * gt // cluster, (b + 1) * gt // cluster) for b in range(cluster)]
        bounds = sorted({v for b in live for v in b})
        parts = {}
        for i in idx:
            s, (lo, hi) = ws[i], body[i]
            if lo >= hi:
                parts[i] = dict(head=(s, s + window), segments=[], tail=(s + window, s + window))
                continue
            segs = []
            for a, b in zip(bounds, bounds[1:]):
                if lo <= a and b <= hi:
                    u0, u1 = group_of(a), group_of(b)
                    segs.append(((a, b), [r for r, (g0, g1) in enumerate(share)
                                          if max(u0, g0) < min(u1, g1)]))
            parts[i] = dict(head=(s, lo), segments=segs, tail=(hi, s + window))
        out.append(dict(windows=idx, union=[tuple(u) for u in union], bounds=bounds,
                        shares=[rows_of(g0, g1) for g0, g1 in share], parts=parts))
    return out


def window_per_block(c: int, nb: int, layout: str = "rows", buffers: int = 2) -> int:
    """Windows a block of P1 takes on the current CUDA device for these
    arguments: 1, or 2 where the card cannot hold all clusters of one window
    a block at once (the kernel's choice, by the card's own count)."""
    return _window_plan(c, nb, layout, buffers, scratch=False)


def _window_plan(c: int, nb: int, layout: str, buffers: int, scratch: bool) -> int:
    """The C entry's windows a block (scratch False) or floats of scratch."""
    got = _build.library().gcd_window_sum_plan(c, nb, LAYOUTS.index(layout), buffers, int(scratch))
    if got < 0:
        _build.check(-got, "window_sum")
    return got


def window_staged_rows(ws, window: int, per_block: int = 1) -> int:
    """Rows of x that P1 reads: each cluster's union once, plus every
    window's head and tail (`window_schedule_plain`)."""
    total = 0
    for cl in window_schedule_plain(ws, window, per_block):
        total += sum(hi - lo for lo, hi in cl["union"])
        total += sum(p["head"][1] - p["head"][0] + p["tail"][1] - p["tail"][0]
                     for p in cl["parts"].values())
    return total


def window_sum(x: torch.Tensor, ws: torch.Tensor, window: int, layout: str = "rows",
               buffers: int = 2) -> torch.Tensor:
    """P1: out [len(ws), C] f32, out[i] = sum of the `window` rows of x from
    row ws[i]. A cluster of `WINDOW_CLUSTER` blocks of 1 or 2 windows each
    (`window_per_block`) stages each row of its windows' union once, through
    a ring of `buffers` stages (1: load, wait, sum; 2: the next stage's
    copies in flight while this one is summed), by the rule of
    `window_schedule_plain`.

    x bf16 in `layout`; ws int32 [NB] with 0 <= ws[i] <= N - window (not
    checked on the card: a start outside reads outside x). On the card x
    starts on 16 bytes, and the cols layout needs N % 8 == 0 (the copy
    engine's row pitch is a multiple of 16 bytes)."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}, expected one of {LAYOUTS}")
    if buffers not in (1, 2):
        raise ValueError(f"buffers must be 1 or 2, got {buffers}")
    if x.device.type == "cpu":
        return window_sum_plain(x, ws, window, layout)
    dev = _cuda_device(x, "window_sum")
    _check(x, "x", torch.bfloat16, 3 if layout == "tiles" else 2, dev)
    _check(ws, "ws", torch.int32, 1, dev)
    if layout == "tiles" and x.shape[2] != TILE_ROWS:
        raise ValueError(f"tiles layout is [N / {TILE_ROWS}, C, {TILE_ROWS}], got {tuple(x.shape)}")
    # the shape of the [N, C] view, without the copy `from_layout` makes of tiles
    n, c = {"rows": tuple(x.shape), "cols": tuple(x.shape)[::-1],
            "tiles": (x.shape[0] * TILE_ROWS, x.shape[1])}[layout]
    if c % 8 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"window_sum: C must be a multiple of 8 up to {MAX_CHANNELS}, got {c}")
    if window % STAGE_ROWS or not 0 < window <= n:
        raise ValueError(f"window_sum: window must be a multiple of {STAGE_ROWS} "
                         f"up to N = {n}, got {window}")
    if layout == "cols" and n % 8:
        raise ValueError(f"window_sum: the cols layout needs N % 8 == 0 on the card, got {n}")
    if x.data_ptr() % 16:
        raise ValueError("window_sum: x must start on a 16-byte boundary")
    out = torch.empty((ws.shape[0], c), dtype=torch.float32, device=dev)
    # the blocks' segment sums, read back by the windows of their cluster
    floats = _window_plan(c, ws.shape[0], layout, buffers, scratch=True)
    scratch = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
    rc = _build.library().gcd_window_sum(
        x.data_ptr(), ws.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(), n, c,
        ws.shape[0], window, LAYOUTS.index(layout), buffers,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "window_sum")
    window_sum.launches += 1
    return out


window_sum.launches = 0


# ---------------------------------------------------------------- P2

def gather_sum_plain(x: torch.Tensor, nbr: torch.Tensor, index: str = "dynamic") -> torch.Tensor:
    """Plain P2: `x[nbr.clamp(0)]` masked and summed over k, in f32."""
    if index == "index_only":
        return nbr.sum(1, dtype=torch.int32)[:, None]
    if index == "static":
        return x.float() * nbr.shape[1]
    out = torch.zeros((nbr.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    for k in range(nbr.shape[1]):
        out += _gather_rows(x, nbr[:, k])
    return out


def gather_sum(x: torch.Tensor, nbr: torch.Tensor, index: str = "dynamic",
               unroll: bool = False) -> torch.Tensor:
    """P2: out [N_out, C] f32 = sum over present k of x[nbr[:, k]].

    index "dynamic" reads `nbr`; "static" takes row u itself for every k (the
    same loads without the indirection: K * x[u], needs N_in == N_out);
    "index_only" reads `nbr` and no row of x, and returns int32 [N_out, 1] =
    sum_k nbr[u, k]. `unroll` unrolls the loop over the K = 27 offsets."""
    if index not in INDEX_MODES:
        raise ValueError(f"unknown index mode {index!r}, expected one of {INDEX_MODES}")
    if index == "static" and x.shape[0] != nbr.shape[0]:
        raise ValueError(f"gather_sum static: x has {x.shape[0]} rows, nbr {nbr.shape[0]}")
    if x.device.type == "cpu":
        return gather_sum_plain(x, nbr, index)
    dev = _cuda_device(x, "gather_sum")
    _check(x, "x", torch.bfloat16, 2, dev)
    _check(nbr, "nbr", torch.int32, 2, dev)
    n_out, k = nbr.shape
    c = x.shape[1]
    if c % 8 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"gather_sum: C must be a multiple of 8 up to {MAX_CHANNELS}, got {c}")
    if unroll and k != 27:
        raise ValueError(f"gather_sum: the unrolled loop is built for K = 27, got {k}")
    if index != "index_only" and x.data_ptr() % 16:
        raise ValueError("gather_sum: x must be 16-byte aligned")
    if index == "index_only":
        out = torch.empty((n_out, 1), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((n_out, c), dtype=torch.float32, device=dev)
    rc = _build.library().gcd_gather_sum(
        x.data_ptr(), nbr.data_ptr(), out.data_ptr(), n_out, k, c, INDEX_MODES.index(index),
        int(unroll), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "gather_sum")
    gather_sum.launches += 1
    return out


gather_sum.launches = 0


# ---------------------------------------------------------------- P3

def tile_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain P3: K shifted `x @ W[k]` in f32, rows clipped at both ends."""
    n, k = x.shape[0], w.shape[0]
    xf, wf = x.float(), w.float()
    rows = torch.arange(n, device=x.device)
    out = torch.zeros((n, w.shape[2]), dtype=torch.float32, device=x.device)
    for kq in range(k):
        out += xf[(rows + (kq - k // 2)).clamp(0, n - 1)] @ wf[kq]
    return out


TILE_GEMM_ROWS = 256  # P3: output rows per block
TILE_GEMM_SMEM = 232_448  # bytes of shared memory a block may use on sm_90


def tile_gemm_fits(k: int, ci: int, co: int) -> bool:
    """Whether P3's kernel serves (K, Ci, Co): the window of
    `TILE_GEMM_ROWS` + K - 1 rows of Ci channels (padded to a multiple of 16,
    plus 16 bytes a row) and three ring stages of 64 x (96 or 128) weights must
    fit into a block's shared memory. The C entry applies the same rule."""
    ci_pad = -(-ci // 16) * 16
    window = (TILE_GEMM_ROWS + k - 1) * (ci_pad + 8) * 2
    stage = (96 if co <= 96 else 128) * 64 * 2
    s16 = ci_pad // 16  # the channels go through in chunks of 64, 48, 32 or 16
    steps = next(d for d in (4, 3, 2, 1) if s16 % d == 0)
    return window + 3 * stage + 1024 <= TILE_GEMM_SMEM and s16 // steps <= 16


def tile_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P3: out [N, Co] f32 = sum_k x[clip(u + k - K // 2, 0, N - 1)] @ w[k],
    x [N, Ci] bf16, w [K, Ci, Co] bf16, Ci a multiple of 8; any N >= 1, any K
    (odd or even), any Co.

    On the card: `wgmma` on a window of x staged once per block of
    `TILE_GEMM_ROWS` rows (`csrc/conv_parts.cu`). Refused there, with the
    reason: an x that is not 16-byte aligned, and a (K, Ci) whose window does
    not fit into shared memory (`tile_gemm_fits`; Ci = 256 fits up to K = 90,
    Ci = 384 at no K)."""
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1] or w.shape[1] % 8 \
            or x.shape[0] < 1 or w.shape[0] < 1 or w.shape[2] < 1:
        raise ValueError(f"tile_gemm: x {tuple(x.shape)}, w {tuple(w.shape)} do not agree, "
                         "are empty, or Ci is not a multiple of 8")
    if x.device.type == "cpu":
        return tile_gemm_plain(x, w)
    dev = _cuda_device(x, "tile_gemm")
    _check(x, "x", torch.bfloat16, 2, dev)
    _check(w, "w", torch.bfloat16, 3, dev)
    k, ci, co = w.shape
    if not tile_gemm_fits(k, ci, co):
        raise ValueError(f"tile_gemm: a window of {TILE_GEMM_ROWS} + K - 1 = "
                         f"{TILE_GEMM_ROWS + k - 1} rows of {ci} channels does not fit into "
                         f"{TILE_GEMM_SMEM} bytes of shared memory beside three stages of W")
    if x.data_ptr() % 16:
        raise ValueError("tile_gemm: x must be 16-byte aligned")
    lib = _build.library()
    scratch = lib.gcd_tile_gemm_scratch(k, ci, co)
    if scratch < 0:
        raise ValueError(f"tile_gemm: the kernel refuses K {k}, Ci {ci}, Co {co}")
    wimg = torch.empty(scratch, dtype=torch.bfloat16, device=dev)  # W as wgmma reads it
    out = torch.empty((x.shape[0], co), dtype=torch.float32, device=dev)
    rc = lib.gcd_tile_gemm(
        x.data_ptr(), w.data_ptr(), wimg.data_ptr(), out.data_ptr(), x.shape[0], k, ci, co,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "tile_gemm")
    tile_gemm.launches += 1
    return out


tile_gemm.launches = 0


# ---------------------------------------------------------------- P4

def _onehot_blocks(nbr: torch.Tensor):
    """(nbr as [blocks, ONEHOT_ROWS, K] padded with -1, each (block, k)'s
    window start: its smallest present entry, int32 max where none)."""
    n, k = nbr.shape
    pad = -n % ONEHOT_ROWS
    blocks = torch.nn.functional.pad(nbr, (0, 0, 0, pad), value=-1).view(-1, ONEHOT_ROWS, k)
    big = torch.iinfo(torch.int32).max
    return blocks, torch.where(blocks >= 0, blocks, big).amin(1, keepdim=True)


def onehot_far_plain(nbr: torch.Tensor) -> torch.Tensor:
    """How many entries of `nbr` P4 gathers directly: per (block of
    `ONEHOT_ROWS` rows, k) the window starts at the smallest present entry,
    and an entry `ONEHOT_SUBWIN` rows or more above it is outside."""
    blocks, start = _onehot_blocks(nbr)
    return ((blocks >= 0) & (blocks.long() - start >= ONEHOT_SUBWIN)).sum().int()


def onehot_tiles_plain(nbr: torch.Tensor) -> torch.Tensor:
    """[strips, K] int32: how many k16 tiles of its (block, k) window hold an
    entry of each 16-row strip: the one-hot products P4 runs for that
    (strip, offset); 0 for a strip without an entry inside its window."""
    blocks, start = _onehot_blocks(nbr)
    rel = blocks.long() - start
    inside = (blocks >= 0) & (rel < ONEHOT_SUBWIN)
    tile = torch.where(inside, rel // ONEHOT_STRIP, ONEHOT_SUBWIN // ONEHOT_STRIP)
    nb, _, k = blocks.shape
    strips = tile.view(nb, ONEHOT_ROWS // ONEHOT_STRIP, ONEHOT_STRIP, k).transpose(2, 3)
    hit = torch.zeros(strips.shape[:3] + (ONEHOT_SUBWIN // ONEHOT_STRIP + 1,), dtype=torch.bool,
                      device=nbr.device)
    hit.scatter_(3, strips, True)
    return hit[..., :-1].sum(3).int().view(-1, k)[: -(-nbr.shape[0] // ONEHOT_STRIP)]


def onehot_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor):
    """P4: (out [N_out, Co] f32 = sum_k x[nbr[:, k]] @ w[k], far): the conv
    with each (row block, k) gather computed as `onehot(rel) @ window` on
    the tensor cores over a staged window of `ONEHOT_SUBWIN` source rows.
    `far` (int32 scalar) is the number of entries outside their window,
    gathered directly.

    x [N_in, Ci], nbr int32 [N_out, K], w [K, Ci, Co]. On the card: Ci a
    multiple of 8, K up to `ONEHOT_MAX_K`, x 16-byte aligned; anything else
    is refused with the reason."""
    if x.device.type == "cpu":
        return gather_conv(x, nbr, w), onehot_far_plain(nbr)
    dev = _cuda_device(x, "onehot_conv")
    _check(x, "x", torch.bfloat16, 2, dev)
    _check(nbr, "nbr", torch.int32, 2, dev)
    _check(w, "w", torch.bfloat16, 3, dev)
    k, ci, co = w.shape
    if k != nbr.shape[1] or ci != x.shape[1] or ci % 8 or ci < 8 \
            or not 0 < k <= ONEHOT_MAX_K or co < 1:
        raise ValueError(f"onehot_conv: x {tuple(x.shape)}, nbr {tuple(nbr.shape)}, "
                         f"w {tuple(w.shape)} do not agree, or Ci is not a multiple of 8, "
                         f"or K is not in 1 .. {ONEHOT_MAX_K}")
    if x.data_ptr() % 16:
        raise ValueError("onehot_conv: x must be 16-byte aligned")
    lib = _build.library()
    scratch = lib.gcd_onehot_conv_scratch(k, ci, co)
    if scratch < 0:
        raise ValueError(f"onehot_conv: the kernel refuses K {k}, Ci {ci}, Co {co}")
    wimg = torch.empty(scratch, dtype=torch.bfloat16, device=dev)  # W as the lanes read it
    out = torch.empty((nbr.shape[0], co), dtype=torch.float32, device=dev)
    far = torch.zeros((), dtype=torch.int32, device=dev)
    rc = lib.gcd_onehot_conv(
        x.data_ptr(), nbr.data_ptr(), w.data_ptr(), wimg.data_ptr(), out.data_ptr(),
        far.data_ptr(), x.shape[0], nbr.shape[0], k, ci, co,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "onehot_conv")
    onehot_conv.launches += 1
    return out, far


onehot_conv.launches = 0
