"""Cost bisection of the sparse conv K1 (`ops/fused_conv.gather_gemm`) on one
CUDA device: its parts, each timed alone on the same plan.

Run from the repository root:

    python3 -m gcdlss_tpu_torch.tools.conv_parts
    python3 -m gcdlss_tpu_torch.tools.conv_parts --rows 262144 --channels 96
    python3 -m gcdlss_tpu_torch.tools.conv_parts --device cpu --rows 4096 --channels 16

One entry point for what the TPU package spreads over five Pallas diagnostics
(`tools/scaffold_bisect_bench.py`, `kernel_variants_bench.py`,
`fori_diag_bench.py`, `kernel_bisect_bench.py`, `dma_layout_bench.py`). It
builds a level-0 plan with `ops/plan.build_unet_plan` from synthetic 64-beam
scans (`data.synth_scan_points`), K = 27, bf16 activations and weights, f32
sums, and runs on it

  - P1 `window_sum`: staging only, each row of a cluster's windows once,
    by source layout (rows / cols / tiles), window (2048 / 6144 rows per
    block of 256), buffers (1 / 2) and window starts (sequential / random
    multiples of 8);
  - P2 `gather_sum`: the gather only, with the index read from the book
    (dynamic), replaced by the row itself (static) or alone (index_only),
    the loop over the 27 offsets rolled or unrolled;
  - P3 `tile_gemm`: the product only, on rows read at fixed shifts;
  - P4 `onehot_conv`: the conv with the gather as a one-hot product on the
    tensor cores (T2's question: does a gather done on the matrix unit beat
    a real one?);
  - K1 `gather_gemm`: the whole.

P3 multiplies as K1 does, on the tensor cores, but every offset of every row:
K1 skips the (strip of 16 rows, offset) pairs that hold no entry. So the table
prints beside K1 the product at K1's work, P3 times the share of strips K1
keeps (`ops/conv.strips_kept_plain`), and what is left over of K1 after that
and the row gather. P4 computes K1's function with K1's instruction; only
its gather differs.

Every mode is first held against its plain version on the same inputs (any
mismatch exits non-zero), then timed with CUDA events: warm-up, `--reps`
single calls, each behind a spin kernel so that the interval is device time
and not the wrapper's host work (`time_ms`), median and quartiles. Where one PyTorch call computes a
mode's function (P1 rows, sequential starts: `unfold` and `sum` into f32
over the unclamped windows; P2 dynamic: `embedding_bag` with absent entries
as its padding index; P2 static: `mul` into f32, as P2 writes; the index
sum: `sum`; P3: `conv2d` along the rows), that call is held to the plain version and timed
too (`library_ms`): a yardstick, used nowhere in the port. One JSON line per mode, then a table of the parts beside
K1. Without arguments it runs two configurations:
262,144 rows x 96 channels at 0.05 m voxels (the level-0 geometry), and
131,072 rows x 256 channels at 0.4 m voxels (stride 8: the level-3 geometry
as a level-0 plan). `--device cpu` runs the plain versions (small sizes; its
times are the CPU's and are not device numbers). Without a CUDA device and
without `--device cpu` it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..data.quantize_np import sparse_quantize_np
from ..data.synthetic import synth_scan_points
from ..ops import conv_parts as cp
from ..ops.conv import gather_conv, strips_kept_plain
from ..ops.fused_conv import gather_gemm
from ..ops.plan import build_unet_plan
from ..utils.roofline import bound_ms

K = 27
BLOCK = 256  # rows per block of P1
WINDOWS = (2048, 6144)
POINTS_PER_SCAN = 80_000
DEFAULT_CONFIGS = ((262_144, 96, 0.05), (131_072, 256, 0.4))  # rows, channels, voxel size

# max|got - plain| <= tol * max|plain|
TOL = {"P1": 1e-3,  # f32 sums of 2048-6144 bf16 values, in another order than the f64 plain
       "P2": 1e-5,  # f32 sums of 27 bf16 values
       "P3": 1e-2, "P4": 1e-2, "K1": 1e-2}  # K1's tolerance: f32 sums of 27 * C products
LIBRARY_TOL = 2e-2  # a library call's result may be rounded to bf16 (2^-8 of each value)


def log(*args):
    print(*args, flush=True)


def level0_book(rows: int, voxel_size: float, seed: int, device):
    """A level-0 k=3 book [rows, 27] built by the port's plan from synthetic
    scans quantized at `voxel_size` and concatenated in (b, x, y, z) order as
    the loader collates them, cut at `rows`. Returns (nbr, valid, scans)."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((rows, 4), np.int32)
    valid = np.zeros(rows, bool)
    points = min(POINTS_PER_SCAN, max(64, 2 * rows))
    off = scans = 0
    while off < rows and scans < 64:
        vc, _, _ = sparse_quantize_np(synth_scan_points(rng, points), voxel_size)
        take = min(len(vc), rows - off)
        coords[off:off + take, 0] = scans
        coords[off:off + take, 1:] = vc[:take]
        valid[off:off + take] = True
        off += take
        scans += 1
    plan = build_unet_plan(torch.as_tensor(coords, device=device),
                           torch.as_tensor(valid, device=device), (rows,), presorted=True)
    return plan.levels[0].nbr3.contiguous(), plan.levels[0].valid, scans


HOLD_CYCLES = 200_000  # ~0.11 ms of the card's clock: longer than a wrapper's host work


def time_ms(fn, reps: int, on_cuda: bool) -> list:
    """`reps` single calls after 2 warm-ups: CUDA events on the card, the
    host clock on the CPU. On the card a spin kernel of HOLD_CYCLES goes
    ahead of the start event, so that the host has queued the call's
    launches before the card reaches the event: the interval is the call's
    device time, not its wrapper's Python (checks, allocation, the ctypes
    call: tens of microseconds, more than the smallest kernels take)."""
    for _ in range(2):
        fn()
    out = []
    for _ in range(reps):
        if on_cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
    return out


def quartiles(v: list):
    if len(v) < 2:
        return v[0], v[0], v[0]
    q1, med, q3 = statistics.quantiles(v, n=4, method="inclusive")
    return q1, med, q3


def modes(x, w, nbr, rows: int, channels: int) -> list:
    """Every mode of the table: dict(mode, kernel, part, tpu_tool, run,
    plain, exact, bytes (what the kernel moves), min_bytes (each input read
    once, each output written once), flops, and, where one PyTorch call
    computes the same function, library (that call) with library_view (its
    result in the plain version's shape))."""
    dev = x.device
    nnz = int((nbr >= 0).sum())
    xb, nb_bytes = rows * channels * 2, rows * K * 4
    wb, ob = K * channels * channels * 2, rows * channels * 4
    out = []

    # P1: staging
    nblocks = rows // BLOCK
    layouts = {lay: cp.to_layout(x, lay) for lay in cp.LAYOUTS}
    p1 = [(lay, win, buf, False) for lay in cp.LAYOUTS for win in WINDOWS for buf in (1, 2)]
    p1 += [(lay, WINDOWS[0], 2, True) for lay in cp.LAYOUTS]
    tools = {"rows": "tools/dma_layout_bench.py:103 (natural); tools/scaffold_bisect_bench.py:45 "
                     "(base, randws); tools/kernel_bisect_bench.py:82 (dma, dma2)",
             "cols": "tools/dma_layout_bench.py:103 (transposed)",
             "tiles": "tools/dma_layout_bench.py:52 (tile-major)"}
    for lay, win, buf, rand in p1:
        if win > rows:
            continue
        # random starts are multiples of 8, so that every layout still stages
        # whole groups of 8 rows and the modes differ in locality alone
        ws_cpu = cp.window_starts(rows, BLOCK, win, random=rand, align=8)
        ws = ws_cpu.to(dev)
        covered = torch.zeros(rows + 1, dtype=torch.int32)
        covered.index_add_(0, ws_cpu.long(), torch.ones(nblocks, dtype=torch.int32))
        covered.index_add_(0, ws_cpu.long() + win, -torch.ones(nblocks, dtype=torch.int32))
        union = int((covered.cumsum(0)[:rows] > 0).sum())  # rows that some window reads
        # the windows a block takes: the kernel's choice on the card
        per_block = cp.window_per_block(channels, nblocks, lay, buf) if dev.type == "cuda" else 1
        mode = dict(
            mode=f"stage {lay} W{win} {'random' if rand else 'sequential'} buffers {buf}",
            kernel="window_sum", part="P1", tpu_tool=tools[lay],
            run=lambda t=layouts[lay], ws=ws, win=win, lay=lay, buf=buf:
                cp.window_sum(t, ws, win, lay, buf),
            plain=lambda t=layouts[lay], ws=ws, win=win, lay=lay:
                cp.window_sum_plain(t, ws, win, lay),
            bytes=(cp.window_staged_rows(ws_cpu, win, per_block) * channels * 2
                   + nblocks * (4 + channels * 4)),
            min_bytes=union * channels * 2 + nblocks * (4 + channels * 4),
            flops=0, window=win, layout=lay, buffers=buf, windows_per_block=per_block)
        if lay == "rows" and not rand:
            # the library's yardstick: the windows that start at i * BLOCK
            # without the clamp at N - window, as one strided sum; the
            # clamped ones repeat the last of them
            mode.update(library=lambda win=win: x.unfold(0, win, BLOCK).sum(-1, dtype=torch.float32),
                        library_view=lambda t, top=(rows - win) // BLOCK:
                            t[torch.arange(nblocks, device=dev).clamp(max=top)])
        out.append(mode)

    # P2: the gather
    t3 = "tools/fori_diag_bench.py:68"
    p2 = {("dynamic", False): f"tools/kernel_variants_bench.py:80 (nomatmul); {t3} (fori_all)",
          ("dynamic", True): f"{t3} (unrolled)",
          ("static", False): f"{t3} (static_all); tools/kernel_bisect_bench.py:82 (static16)",
          ("static", True): f"{t3} (static_all, unrolled)",
          ("index_only", False): f"tools/scaffold_bisect_bench.py:45 (rel); {t3} (static_gst)",
          ("index_only", True): "tools/scaffold_bisect_bench.py:45 (rel, unrolled)"}
    # the library's yardsticks. dynamic (bf16 out): each row of the book is a
    # bag of `embedding_bag`, an absent entry its padding index N, which
    # points at a zero row appended to x; static: K * x written as f32, the
    # same function as P2's; index_only: a row sum
    nbr_bag = torch.where(nbr < 0, rows, nbr)
    x_bag = torch.cat([x, x.new_zeros(1, channels)])
    static_out = torch.empty((rows, channels), dtype=torch.float32, device=dev)
    p2_library = {
        "dynamic": (lambda: torch.nn.functional.embedding_bag(
            nbr_bag, x_bag, mode="sum", padding_idx=rows), lambda t: t),
        "static": (lambda: torch.mul(x, K, out=static_out), lambda t: t),
        "index_only": (lambda: nbr.sum(1, dtype=torch.int32), lambda t: t[:, None])}
    for (index, unroll), tool in p2.items():
        read = {"dynamic": xb + nb_bytes + ob, "static": xb + ob,
                "index_only": nb_bytes + rows * 4}[index]
        out.append(dict(
            mode=f"gather {index} {'unrolled' if unroll else 'rolled'}",
            kernel="gather_sum", part="P2", tpu_tool=tool,
            run=lambda index=index, unroll=unroll: cp.gather_sum(x, nbr, index, unroll),
            plain=lambda index=index: cp.gather_sum_plain(x, nbr, index),
            exact=index == "index_only", bytes=read, min_bytes=read, flops=0, index=index,
            library=p2_library[index][0], library_view=p2_library[index][1]))

    # P3, P4, K1: products
    dense = 2 * rows * K * channels * channels
    # P3 is a convolution along the rows with the edge rows repeated: the
    # library's yardstick (tensor cores, bf16 out) on the same values, as a
    # channels-last `conv2d` of height 1, so that x stays [N + K - 1, Ci] in
    # memory and the result [N, Co] (cuDNN is slower from the default layout)
    last = torch.channels_last
    x_conv = torch.nn.functional.pad(x.T[None], (K // 2, K // 2), mode="replicate")
    x_conv = x_conv[:, :, None, :].contiguous(memory_format=last)
    w_conv = w.permute(2, 1, 0)[:, :, None, :].contiguous(memory_format=last)
    out.append(dict(
        mode="product", kernel="tile_gemm", part="P3",
        tpu_tool="tools/kernel_variants_bench.py:80 (nogather); tools/kernel_bisect_bench.py:82 "
                 "(nogather); tools/scaffold_bisect_bench.py:45 (gst+dot+w)",
        run=lambda: cp.tile_gemm(x, w), plain=lambda: cp.tile_gemm_plain(x, w),
        library=lambda: torch.nn.functional.conv2d(x_conv, w_conv),
        library_view=lambda t: t[0, :, 0, :].T,
        bytes=xb + wb + ob, min_bytes=xb + wb + ob, flops=dense))
    conv_bytes = xb + nb_bytes + wb + ob
    out.append(dict(
        mode="onehot", kernel="onehot_conv", part="P4",
        tpu_tool="tools/kernel_variants_bench.py:113 (onehot)",
        run=lambda: cp.onehot_conv(x, nbr, w)[0], plain=lambda: gather_conv(x, nbr, w),
        bytes=conv_bytes, min_bytes=conv_bytes, flops=2 * nnz * channels * channels))
    out.append(dict(
        mode="full", kernel="gather_gemm", part="K1",
        tpu_tool="tools/kernel_variants_bench.py:80 (full); tools/fori_diag_bench.py:68 "
                 "(fori_all with the product); tools/kernel_bisect_bench.py:82 (full, full2)",
        run=lambda: gather_gemm(x, nbr, w), plain=lambda: gather_conv(x, nbr, w),
        bytes=conv_bytes, min_bytes=conv_bytes, flops=2 * nnz * channels * channels))
    return out


def _max_rel(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|got - ref|, max|ref|) in f64."""
    return (float((got.double() - ref.double()).abs().max()) if ref.numel() else 0.0,
            float(ref.double().abs().max()) if ref.numel() else 0.0)


def check_window_sum_case(device, n: int, c: int, window: int, nb: int, kind: str) -> float:
    """P1 at one `utils.adversarial.WINDOW_SUM_CASES` entry, starts from
    `utils.adversarial.window_starts`, in every layout that holds it (tiles:
    N % 128 == 0; cols on the card: N % 8 == 0) with 1 and 2 buffers, each
    launch counted once: within TOL["P1"] of max|plain|, two launches the same
    bits. Returns the worst error relative to max|plain|; raises
    AssertionError on a mismatch."""
    from ..utils.adversarial import window_starts

    ws = torch.as_tensor(window_starts(n, window, nb, kind, seed=n + nb), device=device)
    g = torch.Generator().manual_seed(c + nb)
    x = torch.randn(n, c, generator=g).to(device).to(torch.bfloat16)
    worst = 0.0
    for layout in cp.LAYOUTS:
        if (layout == "tiles" and n % cp.TILE_ROWS) or (layout == "cols" and n % 8):
            continue
        held = cp.to_layout(x, layout)
        ref = cp.window_sum_plain(held, ws, window, layout)
        for buffers in (1, 2):
            what = f"P1 {layout} buffers {buffers}, {kind} starts, N {n} C {c} W {window} NB {nb}"
            before = cp.window_sum.launches
            got = cp.window_sum(held, ws, window, layout, buffers)
            again = cp.window_sum(held, ws, window, layout, buffers)
            if device.type == "cuda" and cp.window_sum.launches != before + 2:
                raise AssertionError(f"{what}: the kernel did not launch once a call")
            err, scale = _max_rel(got, ref)
            if got.shape != ref.shape or not err <= TOL["P1"] * scale:
                raise AssertionError(f"{what}: shape {tuple(got.shape)}, max|d| {err} above "
                                     f"{TOL['P1']} x {scale}")
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: two launches differ")
            worst = max(worst, err / max(scale, 1e-30))
    return worst


def check_gather_sum_case(device, n_out: int, n_in: int, k: int, c: int, kind: str) -> float:
    """P2 on `utils.adversarial.book(n_out, n_in, k, kind)` in every mode
    that serves the case (static needs N_in == N_out; the unrolled loop K =
    27), each launch counted once: index_only bit for bit, the others within
    TOL["P2"] of max|plain|. Returns the worst error relative to max|plain|;
    raises AssertionError on a mismatch."""
    from ..utils.adversarial import book

    nbr = torch.as_tensor(book(n_out, n_in, k, kind, seed=n_out + c), device=device)
    g = torch.Generator().manual_seed(c + k)
    x = torch.randn(n_in, c, generator=g).to(device).to(torch.bfloat16)
    worst = 0.0
    for index in cp.INDEX_MODES:
        if index == "static" and n_in != n_out:
            continue
        for unroll in ((False, True) if k == 27 else (False,)):
            what = f"P2 {index} {'unrolled' if unroll else 'rolled'} {kind} {n_out}x{k} from {n_in}, C {c}"
            before = cp.gather_sum.launches
            got = cp.gather_sum(x, nbr, index, unroll)
            if device.type == "cuda" and cp.gather_sum.launches != before + 1:
                raise AssertionError(f"{what}: the kernel did not launch once")
            ref = cp.gather_sum_plain(x, nbr, index)
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)}, expected "
                                     f"{ref.dtype} {tuple(ref.shape)}")
            err, scale = _max_rel(got, ref)
            tol = 0.0 if index == "index_only" else TOL["P2"]
            if not err <= tol * scale:
                raise AssertionError(f"{what}: max|d| {err} above {tol} x {scale}")
            worst = max(worst, err / max(scale, 1e-30))
    return worst


def check_onehot_case(device, n_out: int, n_in: int, k: int, ci: int, co: int,
                      kind: str) -> tuple:
    """P4 on `utils.adversarial.book(n_out, n_in, k, kind)` against
    `gather_conv` within TOL["P4"] of max|plain|, `far` against
    `onehot_far_plain`, two launches the same bits. Returns (error relative
    to max|plain|, far); raises AssertionError on a mismatch."""
    from ..utils.adversarial import book

    what = f"P4 {kind} {n_out}x{k} from {n_in}, {ci}->{co}"
    nbr = torch.as_tensor(book(n_out, n_in, k, kind, seed=n_out + ci + co), device=device)
    g = torch.Generator().manual_seed(ci + co)
    x = torch.randn(n_in, ci, generator=g).to(device).to(torch.bfloat16)
    w = (torch.randn(k, ci, co, generator=g) * (2.0 / (k * ci)) ** 0.5).to(device).to(torch.bfloat16)
    out, far = cp.onehot_conv(x, nbr, w)
    again, far_again = cp.onehot_conv(x, nbr, w)
    ref = gather_conv(x, nbr, w)
    err, scale = _max_rel(out, ref)
    if out.shape != ref.shape or not err <= TOL["P4"] * scale:
        raise AssertionError(f"{what}: shape {tuple(out.shape)}, max|d| {err} above "
                             f"{TOL['P4']} x {scale}")
    if not (torch.equal(out, again) and int(far) == int(far_again)):
        raise AssertionError(f"{what}: two launches differ")
    if int(far) != int(cp.onehot_far_plain(nbr)):
        raise AssertionError(f"{what}: far {int(far)}, plain rule {int(cp.onehot_far_plain(nbr))}")
    return err / max(scale, 1e-30), int(far)


def run_config(device, rows: int, channels: int, voxel_size: float, reps: int, seed: int,
               gpu: str) -> list:
    """Check and time every mode at one configuration; returns the result rows."""
    on_cuda = device.type == "cuda"
    nbr, valid, scans = level0_book(rows, voxel_size, seed, device)
    fill = float((nbr >= 0).float().mean())
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, channels, generator=g).to(device) * valid[:, None]).to(torch.bfloat16)
    w = (torch.randn(K, channels, channels, generator=g)
         * (2.0 / (K * channels)) ** 0.5).to(device).to(torch.bfloat16)
    far = int(cp.onehot_conv(x, nbr, w)[1])
    far_plain = int(cp.onehot_far_plain(nbr))
    entries = int((nbr >= 0).sum())
    kept = float(strips_kept_plain(nbr).float().mean())
    tiles = cp.onehot_tiles_plain(nbr)
    log(f"config: rows {rows} channels {channels} voxel {voxel_size} m, {scans} scans, valid "
        f"{int(valid.sum())}, fill {fill:.4f} ({entries} entries), strips of 16 rows kept "
        f"{kept:.4f}; onehot: {far} entries ({far / max(entries, 1):.4f}) outside their "
        f"window of {cp.ONEHOT_SUBWIN} rows, gathered directly; k16 tiles of the window a "
        f"(strip, offset) with an entry inside multiplies: "
        f"{float(tiles[tiles > 0].float().mean()) if bool((tiles > 0).any()) else 0.0:.3f}")
    if far != far_plain:
        raise SystemExit(f"conv_parts: onehot far count {far} differs from the plain {far_plain}")

    results, plain_ms = [], {}
    for m in modes(x, w, nbr, rows, channels):
        got, ref = m["run"](), m["plain"]()
        if on_cuda:
            torch.cuda.synchronize()
        err = float((got.double() - ref.double()).abs().max())
        scale = float(ref.double().abs().max())
        tol = 0.0 if m.get("exact") else TOL[m["part"]]
        if not err <= tol * scale:
            raise SystemExit(f"conv_parts: mode {m['mode']!r} differs from its plain version: "
                             f"max|d| {err} above {tol} x {scale}")
        library_ms = None
        if "library" in m:
            # cuDNN picks its algorithm by trial: its heuristic choice for the
            # 256-channel convolution is an order of magnitude slower
            with torch.backends.cudnn.flags(enabled=True, benchmark=True):
                lib = m["library_view"](m["library"]())
                lib_err = float((lib.double() - ref.double()).abs().max())
                if not lib_err <= (0.0 if m.get("exact") else LIBRARY_TOL) * scale:
                    raise SystemExit(f"conv_parts: mode {m['mode']!r}: the library call differs "
                                     f"from the plain version: max|d| {lib_err} at scale {scale}")
                library_ms = statistics.median(time_ms(m["library"], reps, on_cuda))
            del lib
        del got, ref
        q1, med, q3 = quartiles(time_ms(m["run"], reps, on_cuda))
        pkey = (m["kernel"], m.get("index"))
        if pkey not in plain_ms:  # one plain timing per function: it repeats the arithmetic
            plain_ms[pkey] = statistics.median(time_ms(m["plain"], 3, on_cuda))
        bound, bound_by = bound_ms(m["min_bytes"], m["flops"])
        row = dict(mode=m["mode"], kernel=m["kernel"], part=m["part"], tpu_tool=m["tpu_tool"],
                   rows=rows, channels=channels, k=K, fill=fill, strips_kept=kept, ms=med,
                   ms_q1=q1, ms_q3=q3,
                   reps=reps, plain_ms=plain_ms[pkey], library_ms=library_ms, bytes=m["bytes"],
                   min_bytes=m["min_bytes"], flops=m["flops"],
                   gb_per_s=m["bytes"] / med / 1e6, tflop_per_s=m["flops"] / med / 1e9,
                   bound_ms=bound, bound_by=bound_by,
                   max_abs_err=err, ref_scale=scale, tolerance=tol, device=gpu)
        for key in ("window", "layout", "buffers", "windows_per_block", "index"):
            if key in m:
                row[key] = m[key]
        if m["part"] == "P4":
            row["far_entries"] = far
        results.append(row)
        log(json.dumps(row))
    summary(results, rows, channels, gpu, kept)
    return results


def summary(results: list, rows: int, channels: int, gpu: str, kept: float) -> None:
    """The parts beside the whole K1 on the same plan; `kept` is the share of
    (strip of 16 rows, offset) pairs K1 multiplies."""
    ms = {r["mode"]: r["ms"] for r in results}
    full = ms["full"]
    stage = f"stage rows W{WINDOWS[0]} sequential buffers 2"
    parts = [("index read (P2 index_only, rolled)", ms["gather index_only rolled"]),
             ("row gather (P2 dynamic, rolled)", ms["gather dynamic rolled"]),
             ("row gather (P2 dynamic, unrolled)", ms["gather dynamic unrolled"]),
             ("row loads without the index (P2 static, rolled)", ms["gather static rolled"]),
             ("product over all offsets, tensor cores (P3)", ms["product"]),
             (f"product at K1's work (P3 x strips kept {kept:.3f})", ms["product"] * kept)]
    if stage in ms:
        parts.append((f"staging, each row once per cluster (P1 rows, W {WINDOWS[0]}, 2 buffers)",
                      ms[stage]))
    parts.append(("gather as a one-hot product on the tensor cores, whole conv (P4)",
                  ms["onehot"]))
    library = {r["mode"]: r["library_ms"] for r in results}
    for name, mode in (("staging by the library (unfold + sum into f32, unclamped windows)",
                        stage),
                       ("row gather by the library (embedding_bag, bf16 out)",
                        "gather dynamic rolled"),
                       ("product by the library (conv2d, bf16 out)", "product")):
        if library.get(mode) is not None:
            parts.append((name, library[mode]))
    left = full - ms["gather dynamic rolled"] - ms["product"] * kept
    log(f"parts of K1 at rows {rows}, channels {channels} -> {channels}, K {K} ({gpu}):")
    log(f"  {'whole conv (K1 gather_gemm)':<66} {full:9.3f} ms  1.000 of K1")
    for name, v in parts:
        log(f"  {name:<66} {v:9.3f} ms  {v / full:5.3f} of K1")
    log(f"  {'left over: K1 - row gather - product at its work':<66} {left:9.3f} ms  "
        f"{left / full:5.3f} of K1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rows", type=int, help="rows N of the level-0 plan (with --channels)")
    ap.add_argument("--channels", type=int, help="channels C -> C (with --rows)")
    ap.add_argument("--voxel-size", type=float, default=0.05,
                    help="voxel size in m of the one configuration given by --rows/--channels")
    ap.add_argument("--reps", type=int, default=10, help="timed launches per mode (>= 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", type=Path, help="also write every result row to this file")
    args = ap.parse_args(argv)
    if (args.rows is None) != (args.channels is None):
        ap.error("--rows and --channels go together")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("conv_parts: no CUDA device (pass --device cpu for the plain versions)")
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    if args.device == "cuda":
        gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        gpu = "cpu (plain versions; times are not device numbers)"
    log(gpu)
    configs = (((args.rows, args.channels, args.voxel_size),) if args.rows is not None
               else DEFAULT_CONFIGS)
    results = []
    for rows, channels, voxel in configs:
        if rows % BLOCK or rows % cp.TILE_ROWS or rows < WINDOWS[0]:
            ap.error(f"--rows must be a multiple of {BLOCK} and at least {WINDOWS[0]}")
        if channels % 8 or channels > cp.MAX_CHANNELS:
            ap.error(f"--channels must be a multiple of 8 up to {cp.MAX_CHANNELS}")
        results += run_config(device, rows, channels, voxel, max(1, args.reps), args.seed, gpu)
    if args.json_out:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
