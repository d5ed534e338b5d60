"""The sparse conv taken apart: four component kernels (CUDA,
`csrc/conv_parts.cu`) with their plain versions, for the cost bisection of
K1 (`fused_conv.gather_gemm`) that `tools/conv_parts.py` runs.

They take the place of the TPU package's Pallas diagnostics under `tools/`
(`scaffold_bisect_bench.py`, `kernel_variants_bench.py`, `fori_diag_bench.py`,
`kernel_bisect_bench.py`, `dma_layout_bench.py`). Those compute wrong results
at the right cost; each part here computes a defined function, so that it can
be held to a plain version:

  P1 `window_sum`   staging without arithmetic: per block i, the window of
                    `window` source rows at `ws[i]` goes through shared
                    memory in chunks and is summed,
                    out[i, c] = sum_{r < window} x[ws[i] + r, c]
  P2 `gather_sum`   the gather without the product:
                    out[u, c] = sum_k [nbr[u, k] >= 0] x[nbr[u, k], c]
  P3 `tile_gemm`    the product without the gather:
                    out[u] = sum_k x[clip(u + k - K // 2, 0, N - 1)] @ W[k]
  P4 `onehot_conv`  the conv itself with the gather done as a product,
                    G = onehot(rel) @ sub over a staged sub-window per (row
                    block, k), then G @ W[k]; entries outside the sub-window
                    are gathered directly, so the result is the conv's for
                    every entry: out[u] = sum_k x[nbr[u, k]] @ W[k]

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
STAGE_ROWS = 32  # rows of a window staged per chunk (P1)
MAX_CHANNELS = 256  # P1, P2: one block covers all channels of a row
INDEX_MODES = ("dynamic", "static", "index_only")
ONEHOT_ROWS = 64  # P4: output rows per block
ONEHOT_SUBWIN = 128  # P4: source rows staged per (block, k)


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


def window_sum(x: torch.Tensor, ws: torch.Tensor, window: int, layout: str = "rows",
               buffers: int = 2) -> torch.Tensor:
    """P1: out [len(ws), C] f32, out[i] = sum of the `window` rows of x from
    row ws[i], each window staged through shared memory in chunks of
    `STAGE_ROWS` rows (`buffers` = 1: load, wait, sum; 2: the next chunk's
    `cp.async` loads in flight while this one is summed).

    x bf16 in `layout`; ws int32 [NB] with 0 <= ws[i] <= N - window (not
    checked on the card: a start outside reads outside x)."""
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
    n, c = from_layout(x, layout).shape
    if c % 8 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"window_sum: C must be a multiple of 8 up to {MAX_CHANNELS}, got {c}")
    if window % STAGE_ROWS or not 0 < window <= n:
        raise ValueError(f"window_sum: window must be a multiple of {STAGE_ROWS} "
                         f"up to N = {n}, got {window}")
    out = torch.empty((ws.shape[0], c), dtype=torch.float32, device=dev)
    rc = _build.library().gcd_window_sum(
        x.data_ptr(), ws.data_ptr(), out.data_ptr(), n, c, ws.shape[0], window,
        LAYOUTS.index(layout), buffers, torch.cuda.current_stream(dev).cuda_stream)
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


def tile_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P3: out [N, Co] f32 = sum_k x[clip(u + k - K // 2, 0, N - 1)] @ w[k]:
    K1's tiling and arithmetic on rows read at fixed shifts, with contiguous
    16-byte loads and no book. x [N, Ci], w [K, Ci, Co]."""
    if x.device.type == "cpu":
        return tile_gemm_plain(x, w)
    dev = _cuda_device(x, "tile_gemm")
    _check(x, "x", torch.bfloat16, 2, dev)
    _check(w, "w", torch.bfloat16, 3, dev)
    k, ci, co = w.shape
    if x.shape[1] != ci or ci % 8:
        raise ValueError(f"tile_gemm: x {tuple(x.shape)}, w {tuple(w.shape)} do not agree, "
                         "or Ci is not a multiple of 8")
    out = torch.empty((x.shape[0], co), dtype=torch.float32, device=dev)
    rc = _build.library().gcd_tile_gemm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], k, ci, co,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "tile_gemm")
    tile_gemm.launches += 1
    return out


tile_gemm.launches = 0


# ---------------------------------------------------------------- P4

def onehot_far_plain(nbr: torch.Tensor) -> torch.Tensor:
    """How many entries of `nbr` P4 gathers directly: per (block of
    `ONEHOT_ROWS` rows, k) the sub-window starts at the smallest present
    entry, and an entry `ONEHOT_SUBWIN` rows or more above it is outside."""
    n, k = nbr.shape
    pad = -n % ONEHOT_ROWS
    blocks = torch.nn.functional.pad(nbr, (0, 0, 0, pad), value=-1).view(-1, ONEHOT_ROWS, k)
    big = torch.iinfo(torch.int32).max
    start = torch.where(blocks >= 0, blocks, big).amin(1, keepdim=True)
    return ((blocks >= 0) & (blocks.long() - start >= ONEHOT_SUBWIN)).sum().int()


def onehot_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor):
    """P4: (out [N_out, Co] f32 = sum_k x[nbr[:, k]] @ w[k], far): the conv
    with each (row block, k) gather computed as `onehot(rel) @ sub` over a
    staged sub-window of `ONEHOT_SUBWIN` source rows. `far` (int32 scalar) is
    the number of entries outside their sub-window, gathered directly.

    x [N_in, Ci], nbr int32 [N_out, K], w [K, Ci, Co]."""
    if x.device.type == "cpu":
        return gather_conv(x, nbr, w), onehot_far_plain(nbr)
    dev = _cuda_device(x, "onehot_conv")
    _check(x, "x", torch.bfloat16, 2, dev)
    _check(nbr, "nbr", torch.int32, 2, dev)
    _check(w, "w", torch.bfloat16, 3, dev)
    k, ci, co = w.shape
    if k != nbr.shape[1] or ci != x.shape[1] or ci % 8:
        raise ValueError(f"onehot_conv: x {tuple(x.shape)}, nbr {tuple(nbr.shape)}, "
                         f"w {tuple(w.shape)} do not agree, or Ci is not a multiple of 8")
    out = torch.empty((nbr.shape[0], co), dtype=torch.float32, device=dev)
    far = torch.zeros((), dtype=torch.int32, device=dev)
    rc = _build.library().gcd_onehot_conv(
        x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(), far.data_ptr(),
        x.shape[0], nbr.shape[0], k, ci, co, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "onehot_conv")
    onehot_conv.launches += 1
    return out, far


onehot_conv.launches = 0
