#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gcdlss_tpu_torch`) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:

  1. build: compile `gcdlss_tpu_torch/csrc/*.cu` with nvcc, one process per
     source, all started together (or reuse the library built from the same
     sources), and print the build time;
  2. kernels: the k^3 neighbor map (K3), the gather-GEMM forward (K1) and its
     backward (K2), on CUDA tensors at the Stage-1 path's shapes (2 synthetic
     80k-point scans at 0.05 m voxels, cap0 = 138,240), each held against its
     plain PyTorch version on the same bf16-rounded inputs and timed beside it
     with CUDA events; every K3 map of the plan (L0 k5, L0 k3, L1-L4 k3) bit
     for bit against the join path, two runs the same bits; K1's bf16 result
     must equal its f32 result cast, and two runs of K2 must give the same
     bits;
  3. Stage-2 kernels: the rank-based neighbor map K4 (`plan_kernel=1`) at
     the Stage-2 path's shapes (2 labeled + 2 unlabeled scans, cap0 =
     276,480), at L0 k5, L0 k3 and L1 k3, against its plain version, K3 and
     the join path, bit for bit, and timed beside K3 and the plain version;
     K3 at every map of that plan as in phase 2; then K1/K2 at that plan's
     convs; then K1/K2 on books no plan makes (random, all absent, full,
     ragged row counts and widths, N_in != N_out, a misaligned x) and K3 on
     levels no scan makes (voxels on the faces and corners of the coordinate
     field, no voxel, one voxel, a full cube, long z runs, four equal batches,
     a level cut at its capacity; k1 = 3, 5, 7) against their plain versions,
     and K4 on the same levels (k1 = 3, 5) against its plain version and, off
     the field's faces, K3;
  4. reference: MinkUNet34 forward (eval-mode batch norm) on a small input,
     on the card (kernels) and on the CPU (plain versions) with the same
     weights, relative error <= REF_TOL; then the plan build at the Stage-1
     and Stage-2 caps under `torch.cuda.set_sync_debug_mode("error")` (no
     operation of it may make the host wait for the card);
  5. conv parts: the component kernels P1-P4 of `ops/conv_parts.py` (window
     staging, gather, product, one-hot conv) and K1, every mode of
     `tools/conv_parts.py`, against their plain versions at the tool's two
     configurations (262,144 rows x 96 channels; 131,072 x 256); P3 again at
     ragged shapes (N 1 .. 4,097, K 1, 2, 8, 27, Ci 8 .. 256, Co 20, 96, 256),
     two runs the same bits; P1 at `utils.adversarial.WINDOW_SUM_CASES`
     (cluster remainders, equal, end and unaligned starts, W 32, N = W,
     C 8 .. 256) in every layout with 1 and 2 buffers, two runs the same
     bits; P2 in every mode at ragged shapes and books
     (N_out 1 .. 4,097, C 8 .. 256, K 1, 8, 27; no entry, every entry, the
     last row of x, N_in != N_out); P4 on adversarial books (random, empty,
     one row, one window; Ci 8 .. 256, Co 20 .. 256) against the conv, its
     far count against the plain rule, two runs the same bits; then the
     tool's own `main` at 262,144 x 96, every mode once;
  6. Stage-1 slice: `ExpPretrain` with MinkUNet34 in bf16, 3 steps at batch 2
     through the port's `SemanticKITTIDataset` and `PrefetchLoader`
     (per-scan seeds: the same batches, so the same losses, on every run),
     then `validate` on 2 scans;
  6b. Stage-1.5 slice: `ExpFineTuning` (3 steps at batch 2, Stage 1's caps),
     `ExpMixExtraFineTuning` and `ExpClusterFineTuning` (3 steps each, 2 + 2
     scans, Stage 2's caps; the cluster miner's host time and unknown rows a
     step) warm-started from phase 6's model, `ExpMixCosineFineTuning` (2
     steps) from fresh weights, MinkUNet34 in bf16; then
     `rank_uncertain_scans` over 2 scans, `threshold_sweep_test` over the
     valid scans and its subdivided form (ExpMixExtraTest); finite losses,
     no plan overflow, non-empty sweeps, K1-K3 launched and K4 not;
  7. Stage-2 slice: `ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive` at the
     `bench.py` Stage-2 configuration (MinkUNet34, bf16, 2 + 2 scans), 3
     steps with `plan_kernel=2` and 1 with `plan_kernel=1` through its own
     loaders, then `validate` on 4 scans;
  7b. Stage-2 variants: every recipe of the discovery family at the same
     configuration (`S2_VARIANTS`: fixed-prob, hybrid, oracle and MSP
     thresholds, PolarMix-MT feature mixing, the Sinkhorn assigner, LiON, the
     default recipe with the point-mode mixed plan and with no mixed
     branch), 3 steps each and `validate`, each through a fresh module; per
     config its device and host step times, peak memory, candidates, every
     plan's overflow (combined, mixed, the point-mode quantizer: all 0),
     Sinkhorn's Q rows (sum 1 within 1e-5), launches a step, finite losses;
     before them the point-mode plan against the voxel-mode one on one batch
     pair (`mix_modes_check`: the difference is the straddling voxels alone);
  8. remat: two Stage-1 steps of an f32 MinkUNet34 with `remat` off and on
     from the same weights and batch: equal losses and states, each run's
     peak memory and step times;
  8b. single-model discovery (`nops_phase`): ExpDiscover,
     ExpMixDiscoverJoint, ExpMixDiscover and ExpMixDiscoverSwaV at the
     Stage-2 configuration, 3 steps each through a fresh `train.nops.ExpNops`
     (device and host step times, peak memory, candidates, SwaV's
     cross-view matches, the queue; finite losses, no plan overflow), then
     one step of each on a small input on the card against the CPU
     (`nops_card_vs_cpu`);
  9. CLI: the port's CLI (`python -m gcdlss_tpu_torch.main`, called as
     `main(argv)` in this process) as a user runs it, f32 (its only dtype),
     on one synthetic tree of 80k-point scans at 0.05 m (`cli_runs`): (a)
     Stage 1, MinkUNet34, 2 epochs with a checkpoint each and the handoff;
     (b) the same resumed at epoch 2; (c) `ExpMixExtraFineTuning` and (d)
     Stage 2 at the `bench.py` configuration, both warm-started from (a);
     (e) `--test` on (d)'s saved state, whose mIoU must equal (d)'s last
     validation; (f) Stage 1 at MinkUNet50; (g) the Sinkhorn recipe, (h)
     LiON and (j) PolarMix-MT, one epoch each from (a)'s handoff, and (i)
     `--test` on (h)'s state, its mIoU equal to (h)'s; (k) ExpDiscover and
     (l) ExpMixDiscoverSwaV from (a)'s handoff, (m) (k) resumed at epoch 1;
     (n) Stage 2 at MinkUNet50 from (f)'s handoff (batch 2, cap0 F6_CAP0);
     (o) `ExpClusterFineTuning` from (a)'s handoff and (p) ExpMixExtraTest's
     subdivided sweep on (o)'s state. Every run: finite losses, no
     plan (train or eval) dropping a voxel, K1 and K3 launched (K2 in every
     training run), K4 not; step times, peak memory and the card printed.
     Then the offline clustering evaluation on (d)'s saved state, card
     against CPU (`clustering_eval_check`);
 10. discovery quality (`discovery_phase`): `tools/discovery_quality.py` on
     the card, Stage 1 (12 epochs) then the default Stage-2 recipe (15) on
     the learnable synthetic tree through the CLI; fails unless the last
     mIoU_new reaches 0.10 and the best mIoU_old exceeds the first.
  Phase 2 also holds K1/K2 at MinkUNet50's pool-conv widths (downs 128,
  256, 512 channels; ups 1,024 -> 256, 1,024 -> 128, 512 -> 96, 384 -> 96)
  on the Stage-1 plan, and phase 4 runs the reference forward in bf16 and
  in f32 (the f32 model's convs round x and W to bf16 on the card and keep
  f32 sums). Each phase's wall time is printed.

Each path (the tool's `main`, the Stage-1 slice, each run of the Stage-1.5
slice, the Stage-2 slice, each Stage-2 variant, each single-model recipe,
each CLI run, the discovery-quality run) sets every kernel's launch count to
0 just before it and reads it just after: each kernel of its path must have
launched.
Every kernel row carries its bound, the least time the card could take for
the same work: the larger of its bytes (each input read once, each output
written once) over 3.35 TB/s and its
operations (those this run's data needs: present entries only) over 989
TFLOP/s, the published H100 SXM peaks; `bound_measured_ms` is the same with
the copy bandwidth and the bf16 matmul rate measured in this run;
`library_ms` is the time of one PyTorch call for the same function where
there is one (P2: `embedding_bag`, `mul`, `sum`; P3: `conv2d`), else null. Prints the
card's name and power limit, a JSON line with every kernel comparison, and as
its last line {"ok": true, "device": {...}}. Exits non-zero without that line
when there is no CUDA device or a phase fails. It imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
POINTS_PER_SCAN = 80_000
VOXEL_SIZE = 0.05
CAP0 = 138_240  # Stage 1: 2 scans
BATCH = 2
S2_CAP0 = 2 * CAP0  # Stage 2: 2 labeled scans in [0, CAP0), 2 unlabeled after
OUT_TOL = 1e-2  # max|kernel - plain| <= OUT_TOL * max|plain| (outputs, dX)
DW_TOL = 5e-3  # relative Frobenius error of dW
REF_TOL = 2e-2  # relative Frobenius error of the small-input logits, card vs CPU
PARTS_CONFIG = (262_144, 96)  # rows, channels of the conv-parts tool's main run here
MEASURED = {}  # "bytes_per_s", "bf16_flops": this card, this run (rates_phase)


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, reps: int = 5) -> float:
    import torch

    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_once: int, flops: int) -> dict:
    """The least time for work that moves `nbytes_once` bytes and does
    `flops` bf16-input operations: at the published peaks (`bound_ms`,
    `bound_by`) and at this run's measured rates (`bound_measured_ms`)."""
    from gcdlss_tpu_torch.utils.roofline import bound_ms

    ms, by = bound_ms(nbytes_once, flops)
    measured = bound_ms(nbytes_once, flops, MEASURED["bytes_per_s"], MEASURED["bf16_flops"])[0]
    return dict(bound_ms=ms, bound_by=by, bound_measured_ms=measured,
                library_ms=None)  # K1-K4: no single PyTorch call computes one; P rows take the tool's


def rates_phase(device) -> None:
    """This card's copy bandwidth (a 1 GiB device-to-device copy: read +
    write) and bf16 dense matmul rate (8192^3), for `bound_measured_ms`."""
    import torch

    src = torch.empty(2 ** 30, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    ms = cuda_time_ms(lambda: dst.copy_(src), reps=10)
    MEASURED["bytes_per_s"] = 2 * src.numel() / (ms * 1e-3)
    del src, dst
    a = torch.randn(8192, 8192, device=device).to(torch.bfloat16)
    b = torch.randn(8192, 8192, device=device).to(torch.bfloat16)
    ms = cuda_time_ms(lambda: a @ b, reps=10)
    MEASURED["bf16_flops"] = 2 * 8192 ** 3 / (ms * 1e-3)
    log(f"rates: device-to-device copy {MEASURED['bytes_per_s'] / 1e12:.3f} TB/s (read + write), "
        f"bf16 matmul {MEASURED['bf16_flops'] / 1e12:.1f} TFLOP/s")


def voxel_batch(rng, device, sides: int = 1):
    """`sides` groups of BATCH synthetic scans quantized at VOXEL_SIZE, each
    group concatenated in (b, x, y, z) order into CAP0 rows as the host
    loader collates them, the groups one after another (Stage 2's labeled
    and unlabeled buffers, batch indices continuing across them)."""
    import torch

    from gcdlss_tpu_torch.data import synth_scan_points
    from gcdlss_tpu_torch.data.quantize_np import sparse_quantize_np

    coords = np.zeros((sides * CAP0, 4), np.int32)
    valid = np.zeros(sides * CAP0, bool)
    for side in range(sides):
        off = side * CAP0
        for b in range(side * BATCH, (side + 1) * BATCH):
            vc, _, _ = sparse_quantize_np(synth_scan_points(rng, POINTS_PER_SCAN), VOXEL_SIZE)
            take = min(len(vc), (side + 1) * CAP0 - off)
            coords[off:off + take, 0] = b
            coords[off:off + take, 1:] = vc[:take]
            valid[off:off + take] = True
            off += take
    return torch.as_tensor(coords, device=device), torch.as_tensor(valid, device=device)


def cube_map_rows(plan, tag: str) -> list:
    """K3 at every map of `plan` (L0 k5, L0 k3, L1-L4 k3): bit for bit
    against the join path, two launches the same bits, and its time (the
    wrapper's: checks, allocation and launch) beside the join path's and its
    bound, the map's and the keys' bytes once. `launch_only_ms` is the C
    entry called in a loop on a map allocated once: what the card takes when
    the host does not hold it back (the small maps are shorter than the
    wrapper's own work on the host)."""
    import torch

    from gcdlss_tpu_torch.ops import _build
    from gcdlss_tpu_torch.ops.plan import join_neighbor_map
    from gcdlss_tpu_torch.ops.plan_kernel import cube_neighbor_map

    rows = []
    entry = _build.library().gcd_cube_map
    stream = torch.cuda.current_stream(plan.stem_nbr.device).cuda_stream
    for lev, lv in enumerate(plan.levels):
        for k1 in ((5, 3) if lev == 0 else (3,)):
            got = cube_neighbor_map(lv.key_hi, lv.key_lo, k1)
            ref = join_neighbor_map(lv.key_hi, lv.key_lo, k1)
            mism = int((got != ref).sum())
            if not torch.equal(got, cube_neighbor_map(lv.key_hi, lv.key_lo, k1)):
                raise AssertionError(f"K3 {tag} L{lev} k{k1}: two launches differ")
            if k1 == 5 and not torch.equal(got, plan.stem_nbr):
                raise AssertionError(f"K3 {tag}: the plan's stem map differs from a fresh launch")
            ms = cuda_time_ms(lambda: cube_neighbor_map(lv.key_hi, lv.key_lo, k1), reps=20)
            pms = cuda_time_ms(lambda: join_neighbor_map(lv.key_hi, lv.key_lo, k1))
            kms = cuda_time_ms(lambda: _build.check(entry(
                lv.key_hi.data_ptr(), lv.key_lo.data_ptr(), got.data_ptr(), got.shape[0], k1,
                stream), "gcd_cube_map"), reps=100)
            b = bound(nbytes(lv.key_hi, lv.key_lo, got), 0)
            rows.append(dict(name=f"K3 cube_map {tag} L{lev} k{k1}", route="cuda",
                             source="gcdlss_tpu_torch/csrc/cube_map.cu",
                             replaces="gcdlss_tpu/ops/plan_kernel.py:378",
                             max_abs_err=float(mism), ms=ms, plain_ms=pms, launch_only_ms=kms,
                             **b))
            log(f"K3 {tag} L{lev} k{k1}: cap {lv.key_hi.shape[0]} mismatches {mism} | kernel "
                f"{ms:.4f} ms (launch only {kms:.4f}), plain {pms:.3f} ms, bound "
                f"{b['bound_ms']:.4f} ms")
            if mism:
                raise AssertionError(f"K3 {tag} L{lev} k{k1}: {mism} entries differ from the join path")
    return rows


def cube_map_adversarial_phase(device) -> None:
    """K3 against the join path and the per-row rule it is built on
    (`cube_direct_rule`, evaluated on the CPU) on the levels of
    `utils.adversarial.neighbor_map_levels`, k1 = 3, 5, 7, bit for bit, two
    launches the same bits."""
    import torch

    from gcdlss_tpu_torch.ops.coords import encode_coords, sorted_unique
    from gcdlss_tpu_torch.ops.plan import join_neighbor_map
    from gcdlss_tpu_torch.ops.plan_kernel import cube_direct_rule, cube_neighbor_map
    from gcdlss_tpu_torch.utils.adversarial import neighbor_map_levels

    levels = neighbor_map_levels()
    for name, (coords, cap) in levels.items():
        c = torch.as_tensor(coords, device=device)
        hi, lo = encode_coords(c, torch.ones(len(c), dtype=torch.bool, device=device))
        (kh, kl), _, _, _ = sorted_unique(hi, lo, cap)
        for k1 in (3, 5, 7):
            got = cube_neighbor_map(kh, kl, k1)
            again = cube_neighbor_map(kh, kl, k1)
            ref = join_neighbor_map(kh, kl, k1)
            mism = int((got != ref).sum())
            if mism or not torch.equal(got, again):
                raise AssertionError(f"K3 adversarial {name} k{k1}: {mism} entries differ from the "
                                     f"join path, two launches equal: {torch.equal(got, again)}")
            if k1 < 7 and not torch.equal(got.cpu(), cube_direct_rule(kh.cpu(), kl.cpu(), k1)):
                raise AssertionError(f"K3 adversarial {name} k{k1}: differs from the per-row rule")
    torch.cuda.synchronize()
    log(f"K3 adversarial: {len(levels)} levels ({', '.join(levels)}) x k1 3, 5, 7 bit-equal to "
        f"the join path, two launches each")


def check_cube_candidates_level(device, name: str, k1: int) -> None:
    """K4 on the level `name` of `utils.adversarial.neighbor_map_levels`
    (caps no multiple of a tile's rows): bit for bit against its plain
    version, two launches the same bits, one launch counted (on the card),
    and equal to K3 on every row but those within k1 // 2 of the field's
    faces, where K4 keeps the JAX package's arithmetic queries and K3 the
    join path's clipped ones."""
    import torch

    from gcdlss_tpu_torch.ops.coords import FIELD, SENTINEL_HI, encode_coords, sorted_unique
    from gcdlss_tpu_torch.ops.plan import _column_ranks
    from gcdlss_tpu_torch.ops.plan_kernel import (cube_candidates_map, cube_candidates_plain,
                                                  cube_neighbor_map)
    from gcdlss_tpu_torch.utils.adversarial import neighbor_map_levels

    coords, cap = neighbor_map_levels()[name]
    c = torch.as_tensor(coords, device=device)
    hi, lo = encode_coords(c, torch.ones(len(c), dtype=torch.bool, device=device))
    (kh, kl), _, _, _ = sorted_unique(hi, lo, cap)
    p, has = _column_ranks(kh != SENTINEL_HI, kh, kl, k1)
    before = cube_candidates_map.launches
    got = cube_candidates_map(kh, kl, p, has, k1)
    if device.type == "cuda" and cube_candidates_map.launches != before + 1:
        raise AssertionError(f"K4 adversarial {name} k{k1}: the kernel did not launch once")
    mism = int((got != cube_candidates_plain(kh, kl, p, has, k1)).sum())
    if mism or not torch.equal(got, cube_candidates_map(kh, kl, p, has, k1)):
        raise AssertionError(f"K4 adversarial {name} k{k1}: {mism} entries differ from the plain "
                             f"version, or two launches differ")
    r = k1 // 2
    x, y, z = kh % FIELD, kl // FIELD, kl % FIELD
    lo_c, hi_c = torch.minimum(x, torch.minimum(y, z)), torch.maximum(x, torch.maximum(y, z))
    inside = (kh == SENTINEL_HI) | ((lo_c >= r) & (hi_c <= FIELD - 1 - r))
    k3 = cube_neighbor_map(kh, kl, k1)
    mism = int((got[inside] != k3[inside]).sum())
    if mism:
        raise AssertionError(f"K4 adversarial {name} k{k1}: {mism} entries differ from K3 "
                             f"inside the field")


def cube_candidates_adversarial_phase(device) -> None:
    """K4 at every level of `utils.adversarial.neighbor_map_levels`, k1 = 3
    and 5 (`check_cube_candidates_level`)."""
    import torch

    from gcdlss_tpu_torch.utils.adversarial import neighbor_map_levels

    levels = neighbor_map_levels()
    for name in levels:
        for k1 in (3, 5):
            check_cube_candidates_level(device, name, k1)
    torch.cuda.synchronize()
    log(f"K4 adversarial: {len(levels)} levels ({', '.join(levels)}) x k1 3, 5 bit-equal to the "
        f"plain version, two launches each, and to K3 inside the field")


def window_sum_adversarial_phase(device) -> None:
    """P1 at `utils.adversarial.WINDOW_SUM_CASES` in every layout that holds
    each case, 1 and 2 buffers (`tools.conv_parts.check_window_sum_case`)."""
    import torch

    from gcdlss_tpu_torch.tools.conv_parts import check_window_sum_case
    from gcdlss_tpu_torch.utils.adversarial import WINDOW_SUM_CASES

    worst = max(check_window_sum_case(device, *case) for case in WINDOW_SUM_CASES)
    torch.cuda.synchronize()
    log(f"P1 adversarial: {len(WINDOW_SUM_CASES)} cases (NB no multiple of a cluster, equal "
        f"starts, starts at 0 and N - W, unaligned starts, W 32, N = W, C 8 .. 256, N no "
        f"multiple of 8 or 128, random starts at W 6144), every layout, 1 and 2 buffers, two "
        f"launches bit-equal; worst relative error {worst:.3e}")


def tile_gemm_ragged_phase(device) -> None:
    """P3 against its plain version at `utils.adversarial.TILE_GEMM_SHAPES`
    and at the tool's two full-width shapes, within the tool's tolerance, two
    launches the same bits."""
    import torch

    from gcdlss_tpu_torch.ops.conv_parts import tile_gemm, tile_gemm_plain
    from gcdlss_tpu_torch.tools.conv_parts import DEFAULT_CONFIGS, K, TOL
    from gcdlss_tpu_torch.utils.adversarial import TILE_GEMM_SHAPES

    gen = torch.Generator(device=device).manual_seed(11)
    worst = 0.0
    shapes = TILE_GEMM_SHAPES + tuple((n, K, c, c) for n, c, _ in DEFAULT_CONFIGS)
    for n, k, ci, co in shapes:
        x = torch.randn(n, ci, generator=gen, device=device).to(torch.bfloat16)
        w = (torch.randn(k, ci, co, generator=gen, device=device) * (2.0 / (k * ci)) ** 0.5
             ).to(torch.bfloat16)
        out = tile_gemm(x, w)
        ref = tile_gemm_plain(x, w)
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        if not err <= TOL["P3"] * scale:
            raise AssertionError(f"P3 N {n} K {k} {ci}->{co}: error {err} above {TOL['P3']} x {scale}")
        if not torch.equal(out, tile_gemm(x, w)):
            raise AssertionError(f"P3 N {n} K {k} {ci}->{co}: two launches differ")
        worst = max(worst, err / scale)
    torch.cuda.synchronize()
    log(f"P3 ragged: {len(shapes)} shapes (N, K, Ci, Co) against the plain version, two "
        f"launches each; worst relative error {worst:.3e}")


def plan_sync_case(device, stage: int) -> None:
    """`build_unet_plan` on synthetic scans at the Stage-1 (1) or Stage-2 (2)
    caps under `torch.cuda.set_sync_debug_mode("error")`: an operation that
    makes the host wait for the card raises there. The plan must equal the
    one built without the debug mode."""
    import torch

    from gcdlss_tpu_torch.ops.plan import build_unet_plan
    from gcdlss_tpu_torch.train.common import default_caps

    caps = default_caps(CAP0 if stage == 1 else S2_CAP0)
    coords, valid = voxel_batch(np.random.default_rng(7), device, sides=stage)
    ref = build_unet_plan(coords, valid, caps, presorted=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = build_unet_plan(coords, valid, caps, presorted=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not (torch.equal(plan.stem_nbr, ref.stem_nbr) and torch.equal(plan.inverse, ref.inverse)
            and all(torch.equal(a.nbr3, b.nbr3) for a, b in zip(plan.levels, ref.levels))
            and all(torch.equal(a.children, b.children) for a, b in zip(plan.pools, ref.pools))):
        raise AssertionError(f"plan sync: the stage-{stage} plan differs between two builds")


def plan_sync_phase(device) -> None:
    for stage in (1, 2):
        plan_sync_case(device, stage)
    log("plan sync: build_unet_plan at the Stage-1 and Stage-2 caps ran under "
        "set_sync_debug_mode('error'): no host sync")


def gather_sum_ragged_phase(device) -> None:
    """P2 at `utils.adversarial.GATHER_SUM_CASES` in every mode that serves
    each case (`tools.conv_parts.check_gather_sum_case`)."""
    import torch

    from gcdlss_tpu_torch.tools.conv_parts import check_gather_sum_case
    from gcdlss_tpu_torch.utils.adversarial import GATHER_SUM_CASES

    worst = max(check_gather_sum_case(device, *case) for case in GATHER_SUM_CASES)
    torch.cuda.synchronize()
    log(f"P2 ragged: {len(GATHER_SUM_CASES)} cases (N_out 1 .. 4,097, C 8 .. 256, K 1, 8, 27, "
        f"books empty / full / last row / random, N_in != N_out), every mode; worst relative "
        f"error {worst:.3e}, index_only bit for bit")


def onehot_adversarial_phase(device) -> None:
    """P4 at `utils.adversarial.ONEHOT_CASES` against the conv, `far` against
    the plain rule, two launches the same bits (`tools.conv_parts.check_onehot_case`)."""
    import torch

    from gcdlss_tpu_torch.tools.conv_parts import check_onehot_case
    from gcdlss_tpu_torch.utils.adversarial import ONEHOT_CASES

    results = [check_onehot_case(device, *case) for case in ONEHOT_CASES]
    torch.cuda.synchronize()
    log(f"P4 adversarial: {len(ONEHOT_CASES)} books (random, empty, one row, one window; "
        f"Ci 8 .. 256, Co 20 .. 256, N_in != N_out) against the conv, far counts "
        f"{[far for _, far in results]} as the plain rule, two launches bit-equal; worst "
        f"relative error {max(err for err, _ in results):.3e}")


def kernel_phase(device) -> list:
    import torch

    from gcdlss_tpu_torch.ops.plan import build_unet_plan
    from gcdlss_tpu_torch.train.common import default_caps

    rng = np.random.default_rng(0)
    caps = default_caps(CAP0)
    coords, valid = voxel_batch(rng, device)
    plan = build_unet_plan(coords, valid, caps, presorted=True)
    torch.cuda.synchronize()
    log(f"plan: caps {caps}, valid rows per level "
        f"{[int(lv.valid.sum()) for lv in plan.levels]}")

    rows = cube_map_rows(plan, "stage1")
    return (rows + gemm_phase(plan, device, "stage1")
            + gemm_phase(plan, device, "stage1", mink50_pool_cases(plan)))


def path_cases(plan) -> list:
    """(name, x rows, forward book, adjoint book, Ci, Co) of MinkUNet34's
    convs on `plan`: the stem, the k3 books of L0, L1, L3 and L4, a down and
    an up pool book."""
    lv, pools = plan.levels, plan.pools
    return [
        ("stem L0 k5 1->32", lv[0].valid, plan.stem_nbr, plan.stem_nbr.flip(1), 1, 32),
        ("L0 k3 128->96", lv[0].valid, lv[0].nbr3, lv[0].nbr3.flip(1), 128, 96),
        ("L1 k3 64->64", lv[1].valid, lv[1].nbr3, lv[1].nbr3.flip(1), 64, 64),
        ("L3 k3 256->256", lv[3].valid, lv[3].nbr3, lv[3].nbr3.flip(1), 256, 256),
        ("L4 k3 256->256", lv[4].valid, lv[4].nbr3, lv[4].nbr3.flip(1), 256, 256),
        ("down L0->L1 32->32", lv[0].valid, pools[0].children, pools[0].upmap, 32, 32),
        ("up L4->L3 256->256", lv[4].valid, pools[3].upmap, pools[3].children, 256, 256),
    ]


def mink50_pool_cases(plan) -> list:
    """MinkUNet50's pool convs on `plan`, the widths no MinkUNet34 conv has:
    the downs take 128, 256 and 512 channels (a bottleneck stage's 4x), the
    ups 1,024, 1,024, 512 and 384 (`models.minkunet`, expansion 4)."""
    lv, pools = plan.levels, plan.pools
    cases = []
    for i, (ci, co) in enumerate(((128, 128), (256, 256), (512, 512)), start=1):
        cases.append((f"MinkUNet50 down L{i}->L{i + 1} {ci}->{co}", lv[i].valid,
                      pools[i].children, pools[i].upmap, ci, co))
    for lvl, (ci, co) in zip((3, 2, 1, 0), ((1024, 256), (1024, 128), (512, 96), (384, 96))):
        cases.append((f"MinkUNet50 up L{lvl + 1}->L{lvl} {ci}->{co}", lv[lvl + 1].valid,
                      pools[lvl].upmap, pools[lvl].children, ci, co))
    return cases


def gemm_phase(plan, device, tag: str, cases: list | None = None) -> list:
    """K1/K2 at `cases` (default: the path's convs of `plan`, `path_cases`),
    each against its plain version on the same bf16-rounded inputs, timed
    beside it. Also held: K1's bf16 result equals its f32 result cast, and
    two runs of K2 give the same bits. `strips_kept` is the share of (16-row
    strip, offset) pairs K1 visits and `pairs` the present pairs dW visits,
    both by the plain rules."""
    import torch

    from gcdlss_tpu_torch.ops import conv as plain
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward

    rows = []
    for name, xvalid, nbr, adj, ci, co in cases or path_cases(plan):
        name = f"{tag} {name}"
        nbr, adj = nbr.contiguous(), adj.contiguous()
        k = nbr.shape[1]
        x = (torch.randn(xvalid.shape[0], ci, device=device)
             * xvalid[:, None]).to(torch.bfloat16)
        w = (torch.randn(k, ci, co, device=device) * (2.0 / (k * ci)) ** 0.5).to(torch.bfloat16)
        g = torch.randn(nbr.shape[0], co, device=device).to(torch.bfloat16)

        # the operations this book needs: present entries only; dense = all K
        nnz, flops_entry = int((nbr >= 0).sum()), 2 * ci * co
        dense = bound(0, nbr.numel() * flops_entry)["bound_ms"]
        out = gather_gemm(x, nbr, w)
        ref = plain.gather_conv(x, nbr, w)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not torch.equal(gather_gemm(x, nbr, w, out_dtype=torch.bfloat16),
                           out.to(torch.bfloat16)):
            raise AssertionError(f"K1 {name}: the bf16 result is not the f32 result cast")
        ms = cuda_time_ms(lambda: gather_gemm(x, nbr, w))
        pms = cuda_time_ms(lambda: plain.gather_conv(x, nbr, w))
        kept = float(plain.strips_kept_plain(nbr).float().mean())
        log(f"K1 {name}: max|d| {err:.3e} (max|ref| {scale:.3e}) | "
            f"kernel {ms:.3f} ms, plain {pms:.3f} ms | fill {nnz / nbr.numel():.3f}, "
            f"strips kept {kept:.3f}")
        if not err <= OUT_TOL * scale:
            raise AssertionError(f"K1 {name}: error {err} above {OUT_TOL} x {scale}")
        rows.append(dict(name=f"K1 gather_gemm {name}", route="cuda",
                         source="gcdlss_tpu_torch/csrc/gather_gemm.cu",
                         replaces="gcdlss_tpu/ops/fused_conv.py:312",
                         max_abs_err=err, ms=ms, plain_ms=pms, fill=nnz / nbr.numel(),
                         strips_kept=kept,
                         bound_dense_ms=max(dense, bound(nbytes(x, nbr, w, out), 0)["bound_ms"]),
                         **bound(nbytes(x, nbr, w, out), nnz * flops_entry)))

        dx, dw = gather_gemm_backward(x, g, adj, w)
        rdx, rdw = plain.gather_conv_backward(x, g, adj, w)
        dx_err = float((dx - rdx).abs().max())
        dx_scale = float(rdx.abs().max())
        dw_rel = float(torch.linalg.vector_norm(dw - rdw) / torch.linalg.vector_norm(rdw))
        dx2, dw2 = gather_gemm_backward(x, g, adj, w)
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            raise AssertionError(f"K2 {name}: two runs on the same inputs differ")
        ms = cuda_time_ms(lambda: gather_gemm_backward(x, g, adj, w))
        dw_ms = cuda_time_ms(lambda: gather_gemm_backward(x, g, adj, w, need_dx=False))
        pms = cuda_time_ms(lambda: plain.gather_conv_backward(x, g, adj, w))
        pairs = int((adj >= 0).sum())
        adj_kept = float(plain.strips_kept_plain(adj).float().mean())
        log(f"K2 {name}: dX max|d| {dx_err:.3e} (max|ref| {dx_scale:.3e}), "
            f"dW rel-Frobenius {dw_rel:.3e} | kernel {ms:.3f} ms (dW alone {dw_ms:.3f}), "
            f"plain {pms:.3f} ms | pairs {pairs}, dX strips kept {adj_kept:.3f}")
        if not dx_err <= OUT_TOL * dx_scale:
            raise AssertionError(f"K2 {name}: dX error {dx_err} above {OUT_TOL} x {dx_scale}")
        if not dw_rel <= DW_TOL:
            raise AssertionError(f"K2 {name}: dW relative error {dw_rel} above {DW_TOL}")
        rows.append(dict(name=f"K2 gather_gemm_backward {name}", route="cuda",
                         source="gcdlss_tpu_torch/csrc/gather_gemm.cu",
                         replaces="gcdlss_tpu/ops/fused_conv.py:379",
                         max_abs_err=max(dx_err, float((dw - rdw).abs().max())),
                         ms=ms, dw_only_ms=dw_ms, plain_ms=pms, fill=nnz / nbr.numel(),
                         strips_kept=adj_kept, pairs=pairs,
                         bound_dense_ms=max(2 * dense, bound(nbytes(x, g, adj, w, dx, dw), 0)["bound_ms"]),
                         **bound(nbytes(x, g, adj, w, dx, dw), 2 * nnz * flops_entry)))
    return rows


def adversarial_phase(device) -> None:
    """K1/K2 against their plain versions on books the plans never make, at
    4,096-20,000 rows: a random book with no locality, an all-absent and a
    full one, row counts that are no multiple of any tile, N_in != N_out,
    widths 1 .. 384 (ragged ones included) and an x whose storage starts 2
    bytes off a 16-byte boundary. The reverse-book reading (the adjoint of a
    submanifold book, in place) is held against an explicit flip."""
    import torch

    from gcdlss_tpu_torch.ops import conv as plain
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward

    gen = torch.Generator(device=device).manual_seed(5)

    def book(n_out, n_in, k, kind):
        if kind == "absent":
            return torch.full((n_out, k), -1, dtype=torch.int32, device=device)
        nbr = torch.randint(0, n_in, (n_out, k), generator=gen, device=device, dtype=torch.int32)
        if kind == "full":
            return nbr
        fill = {"random": 0.2, "sparse": 0.01}[kind]
        keep = torch.rand((n_out, k), generator=gen, device=device) < fill
        if kind == "sparse":  # whole strips and whole offsets empty
            keep[n_out // 3:2 * n_out // 3] = False
            keep[:, ::2] = False
        return torch.where(keep, nbr, -1)

    cases = [  # n_out, n_in, k, ci, co, kind
        (4096, 4096, 27, 1, 20, "random"), (5000, 5000, 27, 4, 32, "random"),
        (4099, 6001, 8, 8, 96, "random"), (20000, 7000, 27, 24, 256, "random"),
        (4097, 4097, 27, 48, 20, "sparse"), (6000, 6000, 27, 96, 96, "sparse"),
        (4100, 9000, 8, 192, 32, "random"), (5001, 5001, 27, 384, 256, "random"),
        (4096, 4096, 27, 96, 96, "absent"), (4111, 4111, 27, 48, 32, "full"),
        (4096, 4096, 125, 1, 32, "sparse"), (4500, 4500, 9, 20, 20, "random"),
        (4500, 4500, 3, 64, 128, "full"),
    ]
    worst = 0.0
    for n_out, n_in, k, ci, co, kind in cases:
        # K1 reads nbr and K2 reads adj; neither kernel needs the two to be adjoint
        nbr, adj = book(n_out, n_in, k, kind), book(n_in, n_out, k, kind)
        w = (torch.randn(k, ci, co, generator=gen, device=device) * (2.0 / (k * ci)) ** 0.5
             ).to(torch.bfloat16)
        g = torch.randn(n_out, co, generator=gen, device=device).to(torch.bfloat16)
        store = torch.randn(n_in * ci + 1, generator=gen, device=device).to(torch.bfloat16)
        for off in (0, 1):  # off 1: a contiguous view 2 bytes off the allocation's alignment
            x = store[off:off + n_in * ci].view(n_in, ci)
            what = f"adversarial {kind} {n_out}x{k} from {n_in}, {ci}->{co}, x offset {2 * off} B"
            out = gather_gemm(x, nbr, w)
            ref = plain.gather_conv(x, nbr, w)
            scale = max(float(ref.abs().max()), 1e-6)
            err = float((out - ref).abs().max())
            if not err <= OUT_TOL * scale:
                raise AssertionError(f"K1 {what}: error {err} above {OUT_TOL} x {scale}")
            if not torch.equal(gather_gemm(x, nbr, w, out_dtype=torch.bfloat16),
                               out.to(torch.bfloat16)):
                raise AssertionError(f"K1 {what}: the bf16 result is not the f32 result cast")
            dx, dw = gather_gemm_backward(x, g, adj, w)
            rdx, rdw = plain.gather_conv_backward(x, g, adj, w)
            dx_scale = max(float(rdx.abs().max()), 1e-6)
            dx_err = float((dx - rdx).abs().max())
            dw_norm = float(torch.linalg.vector_norm(rdw))
            dw_rel = float(torch.linalg.vector_norm(dw - rdw)) / max(dw_norm, 1e-6)
            if not (dx_err <= OUT_TOL * dx_scale and dw_rel <= DW_TOL):
                raise AssertionError(f"K2 {what}: dX error {dx_err} (scale {dx_scale}), "
                                     f"dW relative error {dw_rel}")
            # the book read with its columns reversed, in place, against a flipped copy
            flipped = adj.flip(1).contiguous()
            rx, rw = gather_gemm_backward(x, g, flipped, w, reverse=True)
            # dW sums each offset's pairs in the same order either way; dX adds the
            # offsets in the other order, so it is held to the plain version
            rx_err = float((rx - rdx).abs().max())
            if not (rx_err <= OUT_TOL * dx_scale and torch.equal(rw, dw)):
                raise AssertionError(f"K2 {what}: reverse=True differs from the flipped book "
                                     f"(dX error {rx_err}, scale {dx_scale})")
            if gather_gemm_backward(x, g, adj, w, need_dx=False)[0] is not None:
                raise AssertionError(f"K2 {what}: dX returned although not needed")
            worst = max(worst, err / scale, dx_err / dx_scale, dw_rel)
    torch.cuda.synchronize()
    log(f"adversarial: {len(cases)} books x 2 alignments of x, K1, K2 and the reversed reading "
        f"against the plain versions; worst relative error {worst:.3e}")


def stage2_kernel_phase(device) -> list:
    """K4 at the Stage-2 combined plan: bit-exact against its plain version,
    K3 and the join path; kernel-alone and ranks + kernel times. Then K1/K2
    at the same plan's convs."""
    import torch

    from gcdlss_tpu_torch.ops.coords import SENTINEL_HI
    from gcdlss_tpu_torch.ops.plan import _column_ranks, build_unet_plan, join_neighbor_map
    from gcdlss_tpu_torch.ops.plan_kernel import (cube_candidates_map, cube_candidates_plain,
                                                  cube_neighbor_map)
    from gcdlss_tpu_torch.train.common import default_caps

    caps = default_caps(S2_CAP0)
    coords, valid = voxel_batch(np.random.default_rng(3), device, sides=2)
    plan = build_unet_plan(coords, valid, caps, presorted=True, plan_kernel=1)
    torch.cuda.synchronize()
    log(f"K4 plan: caps {caps}, valid rows per level "
        f"{[int(lv.valid.sum()) for lv in plan.levels]}")
    rows = []
    for lev, k1 in ((0, 5), (0, 3), (1, 3)):
        kh, kl = plan.levels[lev].key_hi, plan.levels[lev].key_lo

        def ranks():
            return _column_ranks(kh != SENTINEL_HI, kh, kl, k1)

        p, has = ranks()
        got = cube_candidates_map(kh, kl, p, has, k1)
        mism = {name: int((got != ref).sum()) for name, ref in (
            ("plain", cube_candidates_plain(kh, kl, p, has, k1)),
            ("K3", cube_neighbor_map(kh, kl, k1)),
            ("join", join_neighbor_map(kh, kl, k1)))}
        if lev == 0 and k1 == 5 and not torch.equal(got, plan.stem_nbr):
            raise AssertionError("K4: plan stem map differs from a fresh launch")
        ms = cuda_time_ms(lambda: cube_candidates_map(kh, kl, p, has, k1))
        rms = cuda_time_ms(lambda: cube_candidates_map(kh, kl, *ranks(), k1))
        k3ms = cuda_time_ms(lambda: cube_neighbor_map(kh, kl, k1))
        pms = cuda_time_ms(lambda: cube_candidates_plain(kh, kl, p, has, k1))
        log(f"K4 L{lev} k{k1}: cap {kh.shape[0]} mismatches {mism} | kernel {ms:.3f} ms, "
            f"ranks + kernel {rms:.3f} ms, K3 {k3ms:.3f} ms, plain {pms:.3f} ms")
        if any(mism.values()):
            raise AssertionError(f"K4 L{lev} k{k1}: entries differ: {mism}")
        rows.append(dict(name=f"K4 cube_cand L{lev} k{k1}", route="cuda",
                         source="gcdlss_tpu_torch/csrc/cube_cand.cu",
                         replaces="gcdlss_tpu/ops/plan_kernel.py:75",
                         max_abs_err=float(mism["plain"]), ms=ms, plain_ms=pms,
                         ranks_plus_kernel_ms=rms, k3_ms=k3ms,
                         **bound(nbytes(kh, kl, p, has, got), 0)))
    return rows + cube_map_rows(plan, "stage2") + gemm_phase(plan, device, "stage2")


def reference_phase(device, dtype: str = "bfloat16") -> None:
    """MinkUNet34 forward on a small input: kernels on the card against the
    plain versions on the CPU, same weights, activations in `dtype` on both.
    An f32 model's convs round x and W to bf16 on the card and keep f32
    sums; on the CPU they are f32 throughout."""
    import copy

    import torch

    from gcdlss_tpu_torch.data.quantize_np import sparse_quantize_np
    from gcdlss_tpu_torch.ops.plan import build_unet_plan
    from gcdlss_tpu_torch.train.common import default_caps
    from gcdlss_tpu_torch.train.pretrain import PretrainConfig, make_model

    rng = np.random.default_rng(1)
    pts = rng.uniform([-6, -6, -2], [6, 6, 1], (12_000, 3)).astype(np.float32)
    vc, _, _ = sparse_quantize_np(pts, 0.1)
    cap0 = -(-len(vc) // 256) * 256
    coords = np.zeros((cap0, 4), np.int32)
    coords[:len(vc), 1:] = vc
    valid = np.arange(cap0) < len(vc)
    feats = rng.uniform(0, 1, (cap0, 1)).astype(np.float32) * valid[:, None]
    cfg = PretrainConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                         voxel_caps=default_caps(cap0), dtype=dtype)
    # eval-mode batch norm: with batch statistics, bf16 activations turn a
    # change of f32 summation order alone into ~3% relative change of these
    # logits (reversing the plain conv's offset loop on the CPU: 3.1e-2 in
    # training mode, 2.6e-3 in eval mode), which would hide a real fault
    model = make_model(cfg, torch.Generator().manual_seed(0)).eval()
    outs = {}
    for dev, m in (("cpu", model), (device, copy.deepcopy(model).to(device))):
        with torch.no_grad():
            plan = build_unet_plan(torch.as_tensor(coords, device=dev),
                                   torch.as_tensor(valid, device=dev), cfg.voxel_caps,
                                   presorted=True)
            outs[str(dev)] = m(plan, torch.as_tensor(feats, device=dev))["logits"].cpu()
    ref, got = outs["cpu"], outs[str(device)]
    err = float((got - ref).abs().max())
    rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
    log(f"reference: MinkUNet34 {dtype} logits on {len(vc)} voxels, card vs CPU "
        f"rel-Frobenius {rel:.3e}, max|d| {err:.3e} (max|ref| {float(ref.abs().max()):.3e})")
    # bf16: both sides round every layer's output to bf16; a last-place flip
    # where the f32 sums differ in order propagates through the 34 layers, so
    # the bound is on the whole logit tensor, ~8x the order-flip spread above.
    # f32: the card's convs see bf16-rounded inputs (0.27% on the CPU's
    # emulation of that rounding at this input)
    if not (torch.isfinite(got).all() and rel <= REF_TOL):
        raise AssertionError(f"reference {dtype}: card logits differ from the CPU's by {rel} "
                             f"(relative)")


def part_kernels() -> dict:
    from gcdlss_tpu_torch.ops import conv_parts
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm

    return {"P1": conv_parts.window_sum, "P2": conv_parts.gather_sum,
            "P3": conv_parts.tile_gemm, "P4": conv_parts.onehot_conv, "K1": gather_gemm}


def conv_parts_phase(device, card: str):
    """P1-P4 (and K1 beside them) against their plain versions at the tool's
    two full-width configurations, every mode, within the tool's tolerances
    (`tool.TOL`: P1 1e-3, P2 1e-5, P3 and P4 1e-2 of max|plain|, index_only
    exact; `run_config` exits non-zero on a mismatch); then the tool's `main`
    at PARTS_CONFIG with every mode once, its launches counted. Returns
    (kernel rows, launches of that run)."""
    from gcdlss_tpu_torch.tools import conv_parts as tool

    rows = []
    for n, c, voxel in tool.DEFAULT_CONFIGS:
        for r in tool.run_config(device, n, c, voxel, reps=5, seed=0, gpu=card):
            if r["part"] != "K1":  # K1's rows come from the stage plans
                rows.append(dict(name=f"{r['part']} {r['kernel']} {r['mode']} N{n} C{c}",
                                 route="cuda", source="gcdlss_tpu_torch/csrc/conv_parts.cu",
                                 replaces=r["tpu_tool"].split(" ")[0].rstrip(";"),
                                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                                 plain_ms=r["plain_ms"], **bound(r["min_bytes"], r["flops"]))
                            | {"library_ms": r["library_ms"]}
                            | ({"far_entries": r["far_entries"]} if "far_entries" in r else {}))

    tile_gemm_ragged_phase(device)
    window_sum_adversarial_phase(device)
    gather_sum_ragged_phase(device)
    onehot_adversarial_phase(device)
    kernels = part_kernels()
    out = ROOT / "build" / "conv_parts.json"
    for fn in kernels.values():
        fn.launches = 0
    n, c = PARTS_CONFIG
    rc = tool.main(["--rows", str(n), "--channels", str(c), "--reps", "1", "--json-out", str(out)])
    launches = {name: fn.launches for name, fn in kernels.items()}
    modes = json.loads(out.read_text())
    log(f"conv parts: tool main rc {rc}, {len(modes)} modes at {n} x {c}; launches {launches}")
    if rc != 0 or len(modes) != 24:
        raise AssertionError(f"conv parts: tool main rc {rc}, {len(modes)} modes, expected 24")
    if not all(count > 0 for count in launches.values()):
        raise AssertionError(f"conv parts: a kernel was not launched: {launches}")
    return rows, launches


def write_kitti_tree(root: Path, rng, n_train: int, n_valid: int) -> None:
    """SemanticKITTI layout: `n_train` train scans (seq 00), `n_valid` valid
    scans (seq 08), 80k synthetic points each, labels drawn from the 19
    classes' raw ids."""
    from gcdlss_tpu_torch.data import synth_scan_points
    from gcdlss_tpu_torch.data.meta import KITTI_LEARNING_MAP_INV

    raw_ids = np.array([v for k, v in KITTI_LEARNING_MAP_INV.items() if k >= 0], np.int32)
    for seq, n in (("00", n_train), ("08", n_valid)):
        vdir = root / "sequences" / seq / "velodyne"
        ldir = root / "sequences" / seq / "labels"
        vdir.mkdir(parents=True)
        ldir.mkdir(parents=True)
        for i in range(n):
            pts = synth_scan_points(rng, POINTS_PER_SCAN)
            rem = rng.uniform(0, 1, (POINTS_PER_SCAN, 1)).astype(np.float32)
            np.hstack([pts, rem]).astype(np.float32).tofile(vdir / f"{i:06d}.bin")
            rng.choice(raw_ids, POINTS_PER_SCAN).astype(np.int32).tofile(ldir / f"{i:06d}.label")


def label_space():
    """SemanticKITTI split 1: (unknown raw labels, label mapping, its
    inverse, the unknown slot)."""
    from gcdlss_tpu_torch.data import build_label_mapping, dataset_meta, split_table

    unknown, _ = split_table("SemanticKITTI", 1)
    mapping, inv, unk = build_label_mapping(
        unknown, dataset_meta("SemanticKITTI")["learning_map_inv"].keys())
    return unknown, mapping, inv, unk


def stage1_phase(device, gpu_name: str) -> dict:
    import torch

    from gcdlss_tpu_torch.data import PrefetchLoader, SemanticKITTIDataset
    from gcdlss_tpu_torch.models.minkunet import DEFAULT_PLANES
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
    from gcdlss_tpu_torch.ops.plan_kernel import cube_candidates_map, cube_neighbor_map
    from gcdlss_tpu_torch.train.common import default_caps
    from gcdlss_tpu_torch.train.pretrain import ExpPretrain, PretrainConfig

    # Stage 1 builds its plans with K3 (the default), so K4 must read 0
    kernels = {"K1": gather_gemm, "K2": gather_gemm_backward, "K3": cube_neighbor_map,
               "K4": cube_candidates_map}
    caps = default_caps(CAP0)
    unknown, mapping, inv, unk = label_space()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = Path(tmp)
        write_kitti_tree(root, np.random.default_rng(2), 3 * BATCH, BATCH)
        cfg = PretrainConfig(num_labeled_classes=17, num_classes=19, unknown_label=unk,
                             voxel_caps=caps, arch="MinkUNet34", planes=DEFAULT_PLANES,
                             dtype="bfloat16", steps_per_epoch=3, epochs=50)
        module = ExpPretrain(cfg, mapping, inv, seed=0, device=device)
        train_ds = SemanticKITTIDataset(str(root), "train", voxel_size=VOXEL_SIZE,
                                        downsampling=POINTS_PER_SCAN, augment=True,
                                        label_mapping=mapping, unknown_labels=unknown, seed=0)
        val_ds = SemanticKITTIDataset(str(root), "valid", voxel_size=VOXEL_SIZE,
                                      label_mapping=mapping, unknown_labels=unknown)
        loader = PrefetchLoader(train_ds, BATCH, caps[0], num_workers=2, seed=0)
        vloader = PrefetchLoader(val_ds, BATCH, caps[0], point_cap=POINTS_PER_SCAN,
                                 shuffle=False, num_workers=2, drop_last=False)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        mean_loss = module.train_epoch(loader)
        vm = module.validate(vloader)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    steps = module.step_log
    for i, s in enumerate(steps):
        log(f"stage1 step {i}: loss {s['loss']:.6f} plan_overflow {s['plan_overflow']} "
            f"device time {s['step_ms']:.1f} ms ({gpu_name})")
    log(f"stage1: mean loss {mean_loss:.6f}; validate loss {vm['loss']:.6f} "
        f"mIoU {vm['mIoU']:.6f} confusion sum {int(vm['conf'].sum())}; "
        f"peak memory {peak_gib:.3f} GiB; launches {launches}")
    if len(steps) != 3:
        raise AssertionError(f"stage1: {len(steps)} train steps, expected 3")
    if not all(np.isfinite(s["loss"]) for s in steps):
        raise AssertionError("stage1: non-finite loss")
    if any(s["plan_overflow"] != 0 for s in steps):
        raise AssertionError("stage1: the plan dropped voxels (plan_overflow > 0)")
    if not vm["conf"].sum() > 0:
        raise AssertionError("stage1: empty confusion matrix")
    if not all(launches[k] > 0 for k in ("K1", "K2", "K3")):
        raise AssertionError(f"stage1: a kernel was not launched: {launches}")
    if launches["K4"] != 0:
        raise AssertionError(f"stage1: K4 launched on the default K3 route: {launches}")
    weights = {k: v.detach().cpu() for k, v in module.state.model.state_dict().items()}
    return launches, weights


S15_RUNS = (  # (registry recipe, voxel caps, scans a step, warm start, steps)
    ("ExpFineTuning", CAP0, BATCH, True, 3),
    ("ExpMixExtraFineTuning", S2_CAP0, 2 * BATCH, True, 3),
    ("ExpMixCosineFineTuning", CAP0, BATCH, False, 2),  # a linear `final` fits no cosine head
    ("ExpClusterFineTuning", S2_CAP0, 2 * BATCH, True, 3),
)


def stage15_phase(device, card: str, pretrained: dict) -> dict:
    """Stage 1.5 as a user runs it, on the port's own datasets and loaders:
    `ExpFineTuning` and `ExpMixExtraFineTuning` warm-started from the Stage-1
    phase's model, `ExpMixCosineFineTuning` from fresh weights and
    `ExpClusterFineTuning` warm-started (S15_RUNS; its host miner timed and
    its unknown rows counted a step), then `rank_uncertain_scans` over 2
    unlabeled scans with the fine-tuned model, `threshold_sweep_test`
    (ExpRCTest) over the valid scans with the Extra-tuned one and the
    subdivided sweep (ExpMixExtraTest, `subdivide=True`) with the
    cluster-tuned one. Every plan's overflow is read on the same batches
    outside the runs. Returns the kernels' launches per run and in all."""
    import torch

    from gcdlss_tpu_torch.data import SemanticKITTIDataset
    from gcdlss_tpu_torch.eval.sweep import threshold_sweep_test
    from gcdlss_tpu_torch.models.minkunet import DEFAULT_PLANES
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
    from gcdlss_tpu_torch.ops.plan import build_unet_plan, plan_capacity_overflow
    from gcdlss_tpu_torch.ops.plan_kernel import cube_candidates_map, cube_neighbor_map
    from gcdlss_tpu_torch.train.common import default_caps, voxel_batch_to_device
    from gcdlss_tpu_torch.train import finetune
    from gcdlss_tpu_torch.train.discover import _combine_batches
    from gcdlss_tpu_torch.train.finetune import ExpFineTuning
    from gcdlss_tpu_torch.train.registry import finetune_config, subdivide_novel
    from gcdlss_tpu_torch.train.uncertainty import rank_uncertain_scans

    kernels = {"K1": gather_gemm, "K2": gather_gemm_backward, "K3": cube_neighbor_map,
               "K4": cube_candidates_map}
    unknown, mapping, inv, unk = label_space()
    fields = dict(num_labeled_classes=17, num_classes=19, unknown_label=unk, arch="MinkUNet34",
                  planes=DEFAULT_PLANES, dtype="bfloat16", steps_per_epoch=3, epochs=50)
    common = dict(voxel_size=VOXEL_SIZE, label_mapping=mapping, unknown_labels=unknown)
    launches, modules = {}, {}
    miner = []  # (host ms, rows marked unknown) of each call of the cluster miner
    mine = finetune._cluster_unknown_mask_host

    def timed_miner(*args):
        t0 = time.perf_counter()
        mask = mine(*args)
        miner.append((round((time.perf_counter() - t0) * 1e3, 1), int(mask.sum())))
        return mask

    def counted(tag: str, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launches[tag] = {name: k.launches for name, k in kernels.items()}
        return out, torch.cuda.max_memory_allocated() / 2 ** 30

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = Path(tmp)
        write_kitti_tree(root, np.random.default_rng(6), 12, BATCH)

        def dataset(n_lab: int, labeled: bool, augment: bool = True):
            return SemanticKITTIDataset(str(root), "train", split_indices=np.arange(n_lab),
                                        labeled=labeled, downsampling=POINTS_PER_SCAN,
                                        augment=augment, resize_aug=labeled and augment,
                                        seed=0 if labeled else 1, **common)

        for name, cap0, scans, warm, steps in S15_RUNS:
            caps = default_caps(cap0)
            _, cfg = finetune_config(name, voxel_caps=caps, batch_size=scans, **fields)
            module = ExpFineTuning(cfg, pretrained if warm else None, seed=0, device=device)
            sides = ((dataset(2 * steps, True), dataset(2 * steps, False)) if module.extra
                     else (dataset(scans * steps, True),))
            finetune._cluster_unknown_mask_host = timed_miner
            try:
                _, peak = counted(name, lambda: module.train_epoch(
                    *module.make_loaders(*sides, batch_size=scans, num_workers=2)))
            finally:
                finetune._cluster_unknown_mask_host = mine
            # the same batches again (per-scan seeds), for the plans' overflow
            overflow = []
            for batch in zip(*module.make_loaders(*sides, batch_size=scans, num_workers=2)):
                vbs = [voxel_batch_to_device(b["voxel"], device) for b in batch]
                vb = _combine_batches(*vbs, cfg) if module.extra else vbs[0]
                overflow.append(plan_capacity_overflow(build_unet_plan(
                    vb["coords"], vb["valid"], caps, presorted=True)))
            overflow = torch.stack(overflow).tolist()
            terms = ("loss", "seg", "calib") + (("unsup_seg", "thr") if module.extra else ())
            for i, s in enumerate(module.step_log):
                log(f"stage1.5 {name} step {i}: " + " ".join(f"{k} {s[k]:.6f}" for k in terms)
                    + f" | plan_overflow {overflow[i]} | device time {s['step_ms']:.1f} ms "
                    f"({card})")
            log(f"stage1.5 {name}: peak memory {peak:.3f} GiB ({card}); launches "
                f"{launches[name]}")
            if len(module.step_log) != steps or len(overflow) != steps:
                raise AssertionError(f"stage1.5 {name}: {len(module.step_log)} steps, "
                                     f"expected {steps}")
            bad = [(i, k) for i, s in enumerate(module.step_log) for k in terms
                   if not np.isfinite(s[k])]
            if bad:
                raise AssertionError(f"stage1.5 {name}: non-finite (step, term): {bad}")
            if any(overflow):
                raise AssertionError(f"stage1.5 {name}: a plan dropped voxels: {overflow}")
            if cfg.extra_mode == "cluster":
                log(f"stage1.5 {name}: host miner (ms, rows marked unknown) a step {miner} "
                    f"({card})")
                if len(miner) != steps:
                    raise AssertionError(f"stage1.5 {name}: the miner ran {len(miner)} times")
            modules[name] = module

        caps = default_caps(CAP0)
        _, ucfg = finetune_config("ExpUncertaintyCheck", voxel_caps=caps, batch_size=BATCH,
                                  **fields)
        (order, scores), _ = counted("rank", lambda: rank_uncertain_scans(
            modules["ExpFineTuning"].state.model, dataset(10, False, augment=False), ucfg,
            caps[0]))
        log(f"stage1.5 rank_uncertain_scans: order {order.tolist()} scores "
            f"{[round(float(x), 6) for x in scores]}")
        if sorted(order.tolist()) != [0, 1] or not np.isfinite(scores).all():
            raise AssertionError(f"stage1.5: ranking {order} of scores {scores}")

        _, tcfg = finetune_config("ExpRCTest", voxel_caps=caps, batch_size=BATCH, **fields)
        val_ds = SemanticKITTIDataset(str(root), "valid", **common)
        known = [k for k, v in mapping.items() if v != unk]
        novel = [k for k, v in mapping.items() if v == unk]
        sweep, _ = counted("sweep", lambda: threshold_sweep_test(
            modules["ExpMixExtraFineTuning"].state.model, val_ds, tcfg, inv, known, novel,
            num_workers=2, point_cap=POINTS_PER_SCAN))
        _, xcfg = finetune_config("ExpMixExtraTest", voxel_caps=caps, batch_size=BATCH, **fields)
        t0 = time.perf_counter()
        split, _ = counted("sweep_subdivide", lambda: threshold_sweep_test(
            modules["ExpClusterFineTuning"].state.model, val_ds, xcfg, inv, known, novel,
            subdivide=subdivide_novel("ExpMixExtraTest"), num_workers=2,
            point_cap=POINTS_PER_SCAN))
        split_s = time.perf_counter() - t0
    for tag, res in (("sweep", sweep), ("sweep subdivided", split)):
        for t, r in res.items():
            log(f"stage1.5 {tag} threshold {t}: mIoU {r['mIoU']:.6f} old {r['mIoU_old']:.6f} "
                f"new {r['mIoU_new']:.6f} points {int(r['conf'].sum())}")
    log(f"stage1.5 sweep subdivided: {split_s:.1f} s wall ({card})")
    if not all(r["conf"].sum() > 0 for res in (sweep, split) for r in res.values()):
        raise AssertionError("stage1.5: an empty sweep confusion matrix")
    launches["total"] = {k: sum(run[k] for run in launches.values()) for k in kernels}
    log(f"stage1.5: launches {launches}")
    if not all(launches["total"][k] > 0 for k in ("K1", "K2", "K3")):
        raise AssertionError(f"stage1.5: a kernel was not launched: {launches['total']}")
    if launches["total"]["K4"] != 0:
        raise AssertionError(f"stage1.5: K4 launched on the default K3 route: {launches}")
    return launches


S2_LOSS_TERMS = ("loss", "sup_seg", "mse", "lasermix", "calib", "thr_loss", "novel_unsup",
                 "novel_sup", "ncc_unsup")


def stage2_phase(device, gpu_name: str) -> dict:
    """Stage-2 discovery as a user runs it, at the `bench.py` Stage-2
    configuration: `train_epoch` over 3 step pairs with K3 maps, 1 with K4
    maps, then `validate`."""
    import dataclasses

    import torch

    from gcdlss_tpu_torch.data import SemanticKITTIDataset
    from gcdlss_tpu_torch.models.minkunet import DEFAULT_PLANES
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
    from gcdlss_tpu_torch.ops.plan_kernel import cube_candidates_map, cube_neighbor_map
    from gcdlss_tpu_torch.train.common import default_caps
    from gcdlss_tpu_torch.train.discover import DiscoverConfig
    from gcdlss_tpu_torch.train.modules import ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive

    kernels = {"K1": gather_gemm, "K2": gather_gemm_backward, "K3": cube_neighbor_map,
               "K4": cube_candidates_map}
    caps = default_caps(S2_CAP0)
    unknown, mapping, inv, unk = label_space()
    cfg = DiscoverConfig(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                         unknown_label=unk, voxel_caps=caps, sup_voxel_cap=CAP0,
                         mix_voxel_caps=caps, num_sup_scans=BATCH, point_cap=POINTS_PER_SCAN,
                         voxel_size=VOXEL_SIZE, arch="MinkUNet34", planes=DEFAULT_PLANES,
                         dtype="bfloat16", cand_cap=4096, queue_slots=20, queue_per_slot=1024,
                         kmeans_iters=15, steps_per_epoch=1000, plan_kernel=2)
    module = ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive(cfg, mapping, inv, seed=0,
                                                            device=device)
    common = dict(voxel_size=VOXEL_SIZE, downsampling=POINTS_PER_SCAN, augment=True,
                  label_mapping=mapping, unknown_labels=unknown)

    def datasets(root: Path, n_lab: int):
        """Labeled scans 0 .. n_lab - 1 of the tree and the unlabeled rest."""
        split = np.arange(n_lab)
        return (SemanticKITTIDataset(str(root), "train", split_indices=split, labeled=True,
                                     resize_aug=True, seed=0, **common),
                SemanticKITTIDataset(str(root), "train", split_indices=split, labeled=False,
                                     seed=1, **common))

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tree_k3, tree_k4 = Path(tmp) / "k3", Path(tmp) / "k4"
        rng = np.random.default_rng(4)
        write_kitti_tree(tree_k3, rng, 6 * BATCH, 2 * BATCH)
        write_kitti_tree(tree_k4, rng, 2 * BATCH, 0)
        val_ds = SemanticKITTIDataset(str(tree_k3), "valid", voxel_size=VOXEL_SIZE,
                                      label_mapping=mapping, unknown_labels=unknown)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        module.train_epoch(*module.make_loaders(*datasets(tree_k3, 3 * BATCH), num_workers=2))
        module.cfg = dataclasses.replace(cfg, plan_kernel=1)
        module.train_epoch(*module.make_loaders(*datasets(tree_k4, BATCH), num_workers=2))
        vm = module.validate(val_ds, num_workers=2)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    steps = module.step_log
    for i, s in enumerate(steps):
        terms = " ".join(f"{k} {s[k]:.6f}" for k in S2_LOSS_TERMS)
        log(f"stage2 step {i} (plan_kernel {2 if i < 3 else 1}): {terms} | tau {s['tau']:.6f} "
            f"n_cand {s['n_cand']:.0f} n_rel {s['n_rel']:.0f} has_novel {s['has_novel']:.0f} "
            f"plan_overflow {s['plan_overflow']:.0f} | time {s['seconds'] * 1e3:.1f} ms "
            f"({gpu_name})")
    log(f"stage2: validate mIoU {vm['mIoU']:.6f} old {vm['mIoU_old']:.6f} "
        f"new {vm['mIoU_new']:.6f} confusion sum {int(vm['conf'].sum())}; "
        f"peak memory {peak_gib:.3f} GiB ({gpu_name}); launches {launches}")
    if len(steps) != 4:
        raise AssertionError(f"stage2: {len(steps)} train steps, expected 4")
    bad = [(i, k) for i, s in enumerate(steps) for k in S2_LOSS_TERMS + ("tau",)
           if not np.isfinite(s[k])]
    if bad:
        raise AssertionError(f"stage2: non-finite (step, term): {bad}")
    if any(s["plan_overflow"] != 0 for s in steps):
        raise AssertionError("stage2: a plan dropped voxels (plan_overflow > 0)")
    if not any(s["has_novel"] == 1 for s in steps):
        raise AssertionError("stage2: the novel branch never fired (has_novel 0 in every step)")
    if not vm["conf"].sum() > 0:
        raise AssertionError("stage2: empty confusion matrix")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"stage2: a kernel was not launched: {launches}")
    return launches


# (tag, registry recipe, overrides on top of it) of the variants phase: the
# seven recipes beside the default one, the default one with the point-mode
# mixed plan, and with no mixed branch
S2_VARIANTS = (
    ("fixed_prob", "ExpMergeDiscover_LaserMix_MeanTeacher", {}),
    ("hybrid", "ExpMergeDiscover_LaserMix_MeanTeacher_HybridAdaptive", {}),
    ("oracle", "ExpMergeDiscover_LaserMix_MeanTeacher_Oracle_threshold", {}),
    ("msp", "ExpMergeDiscover_LaserMix_MeanTeacher_MSP_threshold", {}),
    ("polarmix", "ExpMergeDiscover_PolarMix_MeanTeacher", {}),
    ("sinkhorn", "ExpMixRealMeanTeacherDiscover", {}),
    ("lion", "ExpMergeDiscover_LaserMix_LiON_MeanTeacher", {}),
    ("point", "ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive", {"mix_plan_mode": "point"}),
    ("none", "ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive", {"mix_mode": "none"}),
)
# the point-mode mixed plan's cap0 when the Stage-2 caps drop voxels there: a
# voxel whose points fall in two pitch bands lands in both mixed scans
POINT_MIX_CAP0 = S2_CAP0 + 18_432
SINKHORN_ROW_TOL = 1e-5  # |row sum of Q - 1| on valid candidate rows


class PlanProbe:
    """Inside, every plan the training and evaluation steps build reports
    on the device, for `read`: the overflow of each plan of
    `train.common.plan_and_gather` (the combined and evaluation plans) and
    of each Stage-2 mixed plan (`train.discover`'s `build_unet_plan`), the
    voxels the point-mode quantizer dropped, and the largest |row sum - 1|
    of the valid rows of each Sinkhorn assignment."""

    NAMES = ("main", "mix", "quantize", "q_row_err")

    def __enter__(self):
        import torch

        from gcdlss_tpu_torch.ops.plan import plan_capacity_overflow
        from gcdlss_tpu_torch.train import common, discover

        self.orig = {"common": common.build_unet_plan, "mix": discover.build_unet_plan,
                     "quantize": discover.sparse_quantize, "sinkhorn": discover.sinkhorn_knopp}
        self.mods = (common, discover)
        self.seen = {k: [] for k in self.NAMES}

        def plan_probe(tag, fn):
            def probe(*args, **kw):
                plan = fn(*args, **kw)
                self.seen[tag].append(plan_capacity_overflow(plan))
                return plan
            return probe

        def quantize_probe(points, batch_idx, valid, voxel_size, capacity):
            vox = self.orig["quantize"](points, batch_idx, valid, voxel_size, capacity)
            self.seen["quantize"].append((vox["count"] - capacity).clamp(min=0))
            return vox

        def sinkhorn_probe(features, head, valid=None, **kw):
            q = self.orig["sinkhorn"](features, head, valid=valid, **kw)
            err = (q.sum(dim=1) - 1.0).abs()
            self.seen["q_row_err"].append(torch.where(valid, err, 0.0).max())
            return q

        common.build_unet_plan = plan_probe("main", self.orig["common"])
        discover.build_unet_plan = plan_probe("mix", self.orig["mix"])
        discover.sparse_quantize = quantize_probe
        discover.sinkhorn_knopp = sinkhorn_probe
        return self

    def __exit__(self, *exc):
        common, discover = self.mods
        common.build_unet_plan = self.orig["common"]
        discover.build_unet_plan = self.orig["mix"]
        discover.sparse_quantize = self.orig["quantize"]
        discover.sinkhorn_knopp = self.orig["sinkhorn"]

    def read(self) -> dict:
        """Per name, the values since the last read, as floats."""
        import torch

        seen, self.seen = self.seen, {k: [] for k in self.NAMES}
        return {k: torch.stack(v).float().tolist() if v else [] for k, v in seen.items()}


def voxel_keys(coords, valid) -> np.ndarray:
    """Packed int64 (b, x, y, z) keys of the valid rows, on the host."""
    from gcdlss_tpu_torch.ops.coords import encode_coords, pack_keys

    return pack_keys(*encode_coords(coords, valid))[valid].cpu().numpy()


def mix_modes_check(module, sup, unsup, caps) -> dict:
    """The point-mode mixed plan against the voxel-mode one on the same
    batch pair and the same draws, with the teacher's pseudo labels.

    On the host, from the points: each point's mixed scan (its own band
    parity) and voxel, each source voxel's mixed scan in voxel mode (its
    center's parity); a source voxel straddles when one of its points goes
    to another mixed scan than its center. The point-mode plan (at
    POINT_MIX_CAP0) must hold exactly the (mixed scan, voxel) pairs of the
    points, the voxel-mode plan exactly those of the source voxels; the two
    may differ only at straddling voxels, so the voxel counts differ by the
    voxels straddling adds less those it takes away; on the voxels both
    hold that no straddling voxel shares, features and labels must be
    equal. Also reports what point mode drops at the Stage-2 `caps`."""
    import dataclasses

    import torch

    from gcdlss_tpu_torch.ops.coords import FIELD
    from gcdlss_tpu_torch.ops.plan import plan_capacity_overflow
    from gcdlss_tpu_torch.train import discover
    from gcdlss_tpu_torch.train.common import (default_caps, plan_and_gather,
                                               point_batch_to_device, voxel_batch_to_device)
    from gcdlss_tpu_torch.train.lasermix import band_parity

    cfg, dev = module.cfg, module.device
    s, vs = cfg.num_sup_scans, cfg.voxel_size
    vbs = [voxel_batch_to_device(b["voxel"], dev) for b in (sup, unsup)]
    pbs = [point_batch_to_device(b["points"], dev) for b in (sup, unsup)]
    na = discover.draw_step_randoms(module.state, cfg)["num_areas"]
    with torch.no_grad():
        plan, feats0, _, mapped0 = plan_and_gather(discover._combine_batches(*vbs, cfg),
                                                   cfg.voxel_caps)
        valid0 = plan.levels[0].valid
        is_sup = (plan.rep < cfg.voxel_caps[0]) & (plan.rep < cfg.sup_voxel_cap)
        module.state.teacher.train()
        maxp, argm = torch.softmax(discover.assemble_dummy_logits(
            module.state.teacher(plan, feats0)), dim=-1).max(dim=-1)
        args = (plan, feats0, mapped0, is_sup, valid0 & ~is_sup, maxp, argm, na, *pbs)
        out = {mode: discover.mixed_plan(dataclasses.replace(
            cfg, mix_plan_mode=mode, mix_voxel_caps=mcaps), *args)
            for mode, mcaps in (("voxel", caps), ("point", default_caps(POINT_MIX_CAP0)))}
        at_caps = discover.mixed_plan(dataclasses.replace(cfg, mix_plan_mode="point",
                                                          mix_voxel_caps=caps), *args)[0]
        step = torch.tensor(vs, dtype=torch.float32, device=dev)
        point_key, center_key, source_key, moved = [], [], [], []
        for side, pb in enumerate(pbs):
            xyz, valid = pb["xyz"], pb["valid"]
            c = torch.floor(xyz / step).to(torch.int32)
            par_p = band_parity(xyz, na)
            par_c = band_parity((c.to(torch.float32) + 0.5) * vs, na)  # lasermix_voxel_groups
            pair = torch.arange(s, dtype=torch.int32, device=dev)[:, None].expand_as(par_p)
            g_p = torch.where(par_p == side, pair, s + pair)  # sup: even bands, unsup: odd
            g_c = torch.where(par_c == side, pair, s + pair)
            for keys, b in ((point_key, g_p), (center_key, g_c), (source_key, side * s + pair)):
                keys.append(torch.cat([b[..., None], c], -1)[valid])
            moved.append((g_p != g_c)[valid])
        cat = [torch.cat(k) for k in (point_key, center_key, source_key, moved)]
        every = torch.ones_like(cat[3])
        m_host = np.unique(voxel_keys(cat[0], every))
        v_host = np.unique(voxel_keys(cat[1], every))
        straddlers = np.unique(voxel_keys(cat[2], cat[3]))
        lvl = {mode: out[mode][0].levels[0] for mode in out}
        m_dev, v_dev = (voxel_keys(lvl[m].coords, lvl[m].valid) for m in ("point", "voxel"))
        dropped_at_caps = (max(len(m_dev) - caps[0], 0), int(plan_capacity_overflow(at_caps)))

    def pair_voxel(keys):  # (mixed or source scan b, voxel) -> (pair b mod S, voxel)
        hi, lo = keys >> 32, keys & 0xFFFFFFFF
        return (((hi // FIELD) % s) * FIELD + hi % FIELD) << 32 | lo

    straddle_pv = np.unique(pair_voxel(straddlers))
    only = np.setxor1d(m_host, v_host)
    shared = np.intersect1d(m_host, v_host)
    shared = shared[~np.isin(pair_voxel(shared), straddle_pv)]
    rows = {"point": np.searchsorted(m_dev, shared), "voxel": np.searchsorted(v_dev, shared)}
    feats = {m: out[m][1].float().cpu().numpy()[rows[m]] for m in out}
    labels = {m: out[m][2].cpu().numpy()[rows[m]] for m in out}
    res = dict(voxels_point=len(m_dev), voxels_voxel=len(v_dev), straddlers=len(straddlers),
               point_only=len(np.setdiff1d(m_host, v_host)),
               voxel_only=len(np.setdiff1d(v_host, m_host)), shared_compared=len(shared),
               feature_mismatch=int((feats["point"] != feats["voxel"]).any(1).sum()),
               label_mismatch=int((labels["point"] != labels["voxel"]).sum()),
               quantizer_drops_at_caps=dropped_at_caps[0], plan_drops_at_caps=dropped_at_caps[1])
    log(f"stage2 variants: point vs voxel mode on one batch pair (num_areas {int(na)}): {res}")
    if not (np.array_equal(m_dev, m_host) and np.array_equal(v_dev, v_host)):
        raise AssertionError("stage2 variants: a mixed plan's voxels differ from the points'")
    if not np.isin(pair_voxel(only), straddle_pv).all():
        raise AssertionError("stage2 variants: point and voxel mode differ off the straddlers")
    if len(m_dev) - len(v_dev) != res["point_only"] - res["voxel_only"]:
        raise AssertionError(f"stage2 variants: voxel counts {len(m_dev)} / {len(v_dev)}")
    if res["feature_mismatch"] or res["label_mismatch"] or not len(shared):
        raise AssertionError(f"stage2 variants: shared voxels differ: {res}")
    return res


def stage2_variants_phase(device, card: str) -> dict:
    """Every Stage-2 recipe of the discovery family as a user runs it, at the
    `bench.py` Stage-2 configuration (MinkUNet34, bf16, 2 + 2 scans of 80k
    points, cap0 276,480): for each of S2_VARIANTS, a fresh module's
    `train_epoch` over 3 step pairs, then `validate` on 4 scans, the kernels'
    counts set to 0 before and read after (train steps and validate apart).
    First `mix_modes_check` on the first batch pair; point mode trains at the
    Stage-2 caps if it drops nothing there, else at POINT_MIX_CAP0. Fails on
    a non-finite loss, any overflow (combined plan, mixed plan, point-mode
    quantizer), a Sinkhorn Q whose valid rows do not sum to 1 within
    SINKHORN_ROW_TOL, or a kernel of the path not launched. Returns the
    launches per config and in all."""
    import torch

    from gcdlss_tpu_torch.data import SemanticKITTIDataset
    from gcdlss_tpu_torch.main import resolve_discover_overrides
    from gcdlss_tpu_torch.models.minkunet import DEFAULT_PLANES
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
    from gcdlss_tpu_torch.ops.plan_kernel import cube_candidates_map, cube_neighbor_map
    from gcdlss_tpu_torch.train.common import default_caps
    from gcdlss_tpu_torch.train.discover import DiscoverConfig
    from gcdlss_tpu_torch.train.modules import ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive

    kernels = {"K1": gather_gemm, "K2": gather_gemm_backward, "K3": cube_neighbor_map,
               "K4": cube_candidates_map}
    caps = default_caps(S2_CAP0)
    unknown, mapping, inv, unk = label_space()
    fields = dict(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                  unknown_label=unk, voxel_caps=caps, sup_voxel_cap=CAP0, mix_voxel_caps=caps,
                  num_sup_scans=BATCH, point_cap=POINTS_PER_SCAN, voxel_size=VOXEL_SIZE,
                  arch="MinkUNet34", planes=DEFAULT_PLANES, dtype="bfloat16", cand_cap=4096,
                  queue_slots=20, queue_per_slot=1024, kmeans_iters=15, steps_per_epoch=1000)
    common = dict(voxel_size=VOXEL_SIZE, downsampling=POINTS_PER_SCAN, augment=True,
                  label_mapping=mapping, unknown_labels=unknown)
    launches, rows = {}, {}

    def counts():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in kernels.items()}

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp, PlanProbe() as probe:
        root = Path(tmp)
        write_kitti_tree(root, np.random.default_rng(4), 6 * BATCH, 2 * BATCH)
        split = np.arange(3 * BATCH)
        lab = SemanticKITTIDataset(str(root), "train", split_indices=split, labeled=True,
                                   resize_aug=True, seed=0, **common)
        unlab = SemanticKITTIDataset(str(root), "train", split_indices=split, labeled=False,
                                     seed=1, **common)
        val_ds = SemanticKITTIDataset(str(root), "valid", voxel_size=VOXEL_SIZE,
                                      label_mapping=mapping, unknown_labels=unknown)
        # the default recipe's module, on the first batch pair (the check's
        # teacher forward moves its statistics: a module of its own)
        module = ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive(
            DiscoverConfig(**fields), mapping, inv, seed=0, device=device)
        res = rows["mix_modes"] = mix_modes_check(
            module, *next(zip(*module.make_loaders(lab, unlab, num_workers=2))), caps)
        point_caps = (caps if not (res["quantizer_drops_at_caps"] or res["plan_drops_at_caps"])
                      else default_caps(POINT_MIX_CAP0))
        for tag, recipe, extra in S2_VARIANTS:
            overrides = {**resolve_discover_overrides(recipe, "SemanticKITTI"), **extra}
            if overrides.get("mix_plan_mode") == "point":
                overrides["mix_voxel_caps"] = point_caps
            cfg = DiscoverConfig(**{**fields, **overrides})
            del module
            torch.cuda.empty_cache()
            module = ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive(cfg, mapping, inv, seed=0,
                                                                    device=device)
            loaders = module.make_loaders(lab, unlab, num_workers=2)
            probe.read()
            torch.cuda.reset_peak_memory_stats()
            for fn in kernels.values():
                fn.launches = 0
            module.train_epoch(*loaders)
            train = counts()
            seen = probe.read()
            vm = module.validate(val_ds, num_workers=2)
            launches[tag] = counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            steps = module.step_log
            n = len(steps)
            per_step = {k: round(v / max(n, 1), 2) for k, v in train.items()}
            finite = all(np.isfinite(st[k]) for st in steps for k in S2_LOSS_TERMS + ("tau",))
            rows[tag] = dict(
                recipe=recipe, mix_cap0=cfg.mix_voxel_caps[0],
                step_ms=[round(st["step_ms"], 1) for st in steps],
                host_ms=[round(st["seconds"] * 1e3, 1) for st in steps], peak_gib=round(peak, 3),
                n_cand=[int(st["n_cand"]) for st in steps], n_rel=[int(st["n_rel"]) for st in steps],
                has_novel=[int(st["has_novel"]) for st in steps],
                cand_overflow=[int(st["cand_overflow"]) for st in steps],
                overflow_main=seen["main"], overflow_mix=seen["mix"],
                quantizer_drops=seen["quantize"], q_row_err=seen["q_row_err"],
                launches_a_step=per_step, launches=launches[tag], finite=finite,
                loss=[round(st["loss"], 6) for st in steps], mIoU=vm["mIoU"])
            log(f"stage2 variant {tag} ({card}): {json.dumps(rows[tag])}")
            if n != 3 or not finite:
                raise AssertionError(f"stage2 variant {tag}: {n} steps, finite {finite}")
            if any(seen["main"]) or any(seen["mix"]) or any(seen["quantize"]):
                raise AssertionError(f"stage2 variant {tag}: a plan dropped voxels: {seen}")
            if cfg.assigner == "sinkhorn" and not (
                    len(seen["q_row_err"]) == n and max(seen["q_row_err"]) <= SINKHORN_ROW_TOL):
                raise AssertionError(f"stage2 variant {tag}: Q rows off 1: {seen['q_row_err']}")
            if not all(launches[tag][k] > 0 for k in ("K1", "K2", "K3")) or launches[tag]["K4"]:
                raise AssertionError(f"stage2 variant {tag}: launches {launches[tag]}")
            if not vm["conf"].sum() > 0:
                raise AssertionError(f"stage2 variant {tag}: empty confusion matrix")
    launches["total"] = {k: sum(run[k] for run in launches.values()) for k in kernels}
    log(f"stage2 variants: launches {launches}")
    return launches


NOPS_RECIPES = ("ExpDiscover", "ExpMixDiscoverJoint", "ExpMixDiscover", "ExpMixDiscoverSwaV")
NOPS_LOSS_TERMS = {"nops": ("loss", "sup_seg", "calib", "novel_unsup", "unsup_mix", "entropy"),
                   "nops_swav": ("loss", "sup_seg", "calib", "swav")}
NCC_SHIFT = 8.0  # NCC logits far above every candidate threshold (the small card-vs-CPU check)
# with no Lloyd round each candidate takes its nearest initial k-means row; a
# candidate within summation-order rounding of two rows' distances may take
# the other on the card (1 of 187 reliable rows on SwaV's second view, NVIDIA
# H100 80GB HBM3): the reliable count within this share of the CPU's
REL_COUNT_TOL = 1e-2


def nops_phase(device, card: str) -> dict:
    """The single-model discovery recipes as a user runs them
    (`train.nops.ExpNops`), at the `bench.py` Stage-2 configuration
    (MinkUNet34, bf16, 2 + 2 scans of 80k points at 0.05 m, cap0 276,480,
    `cand_cap` 4096): for each of NOPS_RECIPES a fresh module's `train_epoch`
    over 3 steps (SwaV: 3 step pairs of two views), the kernels' counts set
    to 0 before and read after. Per step its device time (CUDA events) and
    host time (the step's call until the card is done), peak memory,
    candidates, reliable ones, `has_novel` (SwaV also its cross-view
    matches). Fails on a non-finite loss, a plan dropping a voxel, a queue
    that did not take one row for each step whose novel branch fired, SwaV
    matching no candidate across its views, or a kernel of the path not
    launched. Then `nops_card_vs_cpu`. Returns the launches per recipe and
    in all."""
    import torch

    from gcdlss_tpu_torch.data import SemanticKITTIDataset
    from gcdlss_tpu_torch.models.minkunet import DEFAULT_PLANES
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
    from gcdlss_tpu_torch.ops.plan_kernel import cube_candidates_map, cube_neighbor_map
    from gcdlss_tpu_torch.train import nops
    from gcdlss_tpu_torch.train.common import default_caps
    from gcdlss_tpu_torch.train.registry import nops_config

    kernels = {"K1": gather_gemm, "K2": gather_gemm_backward, "K3": cube_neighbor_map,
               "K4": cube_candidates_map}
    caps = default_caps(S2_CAP0)
    unknown, mapping, inv, unk = label_space()
    fields = dict(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                  unknown_label=unk, arch="MinkUNet34", planes=DEFAULT_PLANES,
                  dtype="bfloat16", cand_cap=4096, steps_per_epoch=1000)
    common = dict(voxel_size=VOXEL_SIZE, downsampling=POINTS_PER_SCAN, augment=True,
                  label_mapping=mapping, unknown_labels=unknown)
    launches, rows = {}, {}
    host = []
    steps_of = {"nops": nops.nops_train_step, "nops_swav": nops.swav_train_step}

    def timed(step):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = step(*args, **kw)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = Path(tmp)
        write_kitti_tree(root, np.random.default_rng(5), 6 * BATCH, 0)
        split = np.arange(3 * BATCH)
        module = None
        for name in NOPS_RECIPES:
            stage, cfg = nops_config(name, voxel_caps=caps, batch_size=2 * BATCH, **fields)
            swav = stage == "nops_swav"
            lab = SemanticKITTIDataset(str(root), "train", split_indices=split, labeled=True,
                                       resize_aug=not swav, seed=0, **common)
            unlab = SemanticKITTIDataset(str(root), "train", split_indices=split,
                                         labeled=False, seed=1, **common)
            del module
            torch.cuda.empty_cache()
            module = nops.ExpNops(cfg, seed=0, device=device, swav=swav)
            loaders = module.make_loaders(lab, unlab, num_workers=2)
            host.clear()
            orig = steps_of[stage]
            setattr(nops, orig.__name__, timed(orig))
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for fn in kernels.values():
                    fn.launches = 0
                module.train_epoch(*loaders)
                torch.cuda.synchronize()
                launches[name] = {k: fn.launches for k, fn in kernels.items()}
            finally:
                setattr(nops, orig.__name__, orig)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            steps = module.step_log
            n = len(steps)
            terms = NOPS_LOSS_TERMS[stage]
            finite = all(np.isfinite(st[k]) for st in steps for k in terms)
            fired = sum(int(st["has_novel"]) for st in steps)
            queued = int(module.state.queue.counts.sum())
            rows[name] = dict(
                stage=stage, step_ms=[round(st["step_ms"], 1) for st in steps],
                host_ms=[round(t, 1) for t in host], peak_gib=round(peak, 3),
                n_cand=[int(st["n_cand"]) for st in steps], n_rel=[int(st["n_rel"]) for st in steps],
                has_novel=[int(st["has_novel"]) for st in steps],
                n_match=[int(st.get("n_match", -1)) for st in steps],
                plan_overflow=[int(st["plan_overflow"]) for st in steps], queue_rows=queued,
                launches_a_step={k: round(v / max(n, 1), 2) for k, v in launches[name].items()},
                launches=launches[name], finite=finite,
                **{k: [round(st[k], 6) for st in steps] for k in terms})
            log(f"nops {name} ({card}): {json.dumps(rows[name])}")
            if n != 3 or not finite:
                raise AssertionError(f"nops {name}: {n} steps, finite {finite}")
            if any(st["plan_overflow"] for st in steps):
                raise AssertionError(f"nops {name}: a plan dropped voxels")
            if queued != min(fired, cfg.queue_slots):
                raise AssertionError(f"nops {name}: the queue holds {queued} rows after {fired} "
                                     "steps whose novel branch fired")
            if swav and not sum(rows[name]["n_match"]) > 0:
                raise AssertionError(f"nops {name}: no candidate matched across the two views")
            if not all(launches[name][k] > 0 for k in ("K1", "K2", "K3")) or launches[name]["K4"]:
                raise AssertionError(f"nops {name}: launches {launches[name]}")
        del module
        torch.cuda.empty_cache()
    nops_card_vs_cpu(device, card)
    launches["total"] = {k: sum(run[k] for run in launches.values()) for k in kernels}
    log(f"nops: launches {launches}")
    return launches


def nops_card_vs_cpu(device, card: str) -> None:
    """One step of each single-model recipe (MinkUNet14, f32, cap0 4,096) on
    the card (kernels) and on the CPU (plain versions) from the same weights
    with the same draws: every loss part within REF_TOL (relative) of the
    CPU's, the candidates and `has_novel` equal, the reliable candidates
    within REL_COUNT_TOL. As `tests/test_torch_gpu.py`'s Stage-2 check
    does, the CPU's plain forward conv rounds its operands to bf16 as the
    card does, the NCC heads' bias is raised by NCC_SHIFT on both sides (so
    that every unlabeled voxel passes the threshold and both sides mine the
    same candidates) and k-means runs no Lloyd round."""
    import torch

    from gcdlss_tpu_torch.ops import conv as plain
    from gcdlss_tpu_torch.ops import fused_conv
    from gcdlss_tpu_torch.train import nops
    from gcdlss_tpu_torch.train.registry import nops_config

    caps = (4096, 4096, 2048, 1024, 512)
    rng = np.random.default_rng(11)
    sides = []
    for _ in range(2):
        pts = rng.integers(-20, 20, size=(2 * caps[0], 3))
        b = rng.integers(0, 2, size=(2 * caps[0], 1))
        c = np.unique(np.concatenate([b, pts], 1), axis=0)[: int(caps[0] // 2 * 0.9)]
        coords = np.zeros((caps[0] // 2, 4), np.int32)
        coords[: len(c)] = c
        labels = rng.integers(0, 18, caps[0] // 2).astype(np.int32)
        sides.append({"coords": coords, "labels": labels, "mapped_labels": labels,
                      "feats": rng.uniform(0, 1, (caps[0] // 2, 1)).astype(np.float32),
                      "valid": np.arange(caps[0] // 2) < len(c),
                      "point_ids": rng.permutation(caps[0] // 2).astype(np.int32)})
    views = sides + [dict(s, coords=s["coords"] + np.array([0, 1, 0, 0], np.int32),
                          feats=rng.uniform(0, 1, s["feats"].shape).astype(np.float32))
                     for s in sides]

    def card_rounding(x, nbr, w, out_dtype=torch.float32):
        return plain.gather_conv(x.bfloat16().float(), nbr, w.bfloat16().float(), out_dtype)

    orig = fused_conv.gather_conv
    failures, report = [], {}
    for name in NOPS_RECIPES:
        stage, cfg = nops_config(name, voxel_caps=caps, batch_size=4, num_labeled_classes=17,
                                 num_unlabeled_classes=2, num_classes=19, unknown_label=17,
                                 arch="MinkUNet14", planes=(16, 16, 32, 32, 32, 16, 16, 16),
                                 feat_dim=16, cand_cap=512, queue_slots=4, kmeans_iters=0,
                                 use_scheduler=False)
        swav = stage == "nops_swav"
        step = nops.swav_train_step if swav else nops.nops_train_step
        draws = nops.draw_step_randoms(nops.create_nops_state(0, cfg, device="cpu"), cfg, swav)
        metrics = {}
        for dev in ("cpu", "cuda"):
            state = nops.create_nops_state(0, cfg, device=dev)
            with torch.no_grad():
                state.model.encoder.final2.bias.add_(NCC_SHIFT)
            batches = [{k: torch.as_tensor(v, device=dev) for k, v in s.items()}
                       for s in (views if swav else sides)]
            d = {k: (tuple(x.to(dev) for x in v) if isinstance(v, tuple) else
                     v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in draws.items()}
            fused_conv.gather_conv = card_rounding if dev == "cpu" else orig
            try:
                _, m = step(state, *batches, cfg, draws=d)
            finally:
                fused_conv.gather_conv = orig
            metrics[dev] = {k: float(v) for k, v in m.items()}
        report[name] = metrics
        for k in NOPS_LOSS_TERMS[stage]:
            got, ref = metrics["cuda"][k], metrics["cpu"][k]
            if not (np.isfinite(got) and abs(got - ref) <= REF_TOL * abs(ref) + 1e-6):
                failures.append((name, k, got, ref))
        for k in ("n_cand", "has_novel"):
            if metrics["cuda"][k] != metrics["cpu"][k]:
                failures.append((name, k, metrics["cuda"][k], metrics["cpu"][k]))
        n_rel = metrics["cuda"]["n_rel"], metrics["cpu"]["n_rel"]
        if abs(n_rel[0] - n_rel[1]) > REL_COUNT_TOL * n_rel[1]:
            failures.append((name, "n_rel", *n_rel))
    log(f"nops card vs CPU (MinkUNet14 f32, cap0 4096; {card}): {json.dumps(report)}")
    if failures:
        raise AssertionError(f"nops card vs CPU: {failures}")


def remat_phase(device, card: str) -> dict:
    """One Stage-1 step pair (two `pretrain_train_step`s) of an f32
    MinkUNet34 with `remat` off and on, from the same weights and batch (2
    synthetic scans at CAP0): both losses of the pair within 1e-5 relative,
    every parameter and batch-norm statistic after it too; prints each
    run's peak memory and each step's device time (two CUDA events). Returns
    the peaks (GiB)."""
    import torch

    from gcdlss_tpu_torch.train.common import default_caps
    from gcdlss_tpu_torch.train.pretrain import (PretrainConfig, create_pretrain_state,
                                                 pretrain_train_step)

    coords, valid = voxel_batch(np.random.default_rng(9), device)
    gen = torch.Generator(device=device).manual_seed(9)
    labels = torch.randint(0, 19, valid.shape, generator=gen, device=device, dtype=torch.int32)
    mapped = torch.randint(0, 18, valid.shape, generator=gen, device=device, dtype=torch.int32)
    batch = {"coords": coords, "valid": valid, "labels": labels,
             "mapped_labels": torch.where(valid, mapped, -1),
             "feats": torch.rand(valid.shape[0], 1, generator=gen, device=device) * valid[:, None]}
    out = {}
    for remat in (False, True):
        cfg = PretrainConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                             voxel_caps=default_caps(CAP0), remat=remat, use_scheduler=False)
        state = create_pretrain_state(0, cfg, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for _ in range(2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss = pretrain_train_step(state, batch, cfg)[1]["loss"]
            end.record()
            losses.append(float(loss))
            ms.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        out[remat] = dict(losses=losses, ms=ms, peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                          sd={k: v.detach().clone() for k, v in
                              state.model.state_dict().items()})
        del state
    off, on = out[False], out[True]
    worst = max(float((on["sd"][k] - v).abs().max() / v.abs().max().clamp(min=1e-6))
                for k, v in off["sd"].items())
    log(f"remat: f32 MinkUNet34 step pair at cap0 {CAP0}: losses off {off['losses']} on "
        f"{on['losses']}; worst relative state difference {worst:.3e}; peak memory off "
        f"{off['peak']:.3f} GiB, on {on['peak']:.3f} GiB; device time a step off "
        f"{[round(t, 1) for t in off['ms']]} ms, on {[round(t, 1) for t in on['ms']]} ms "
        f"({card})")
    for a, b in zip(off["losses"], on["losses"]):
        if not (np.isfinite(a) and abs(a - b) <= 1e-5 * abs(a)):
            raise AssertionError(f"remat: losses {off['losses']} (off) and {on['losses']} (on)")
    if not worst <= 1e-5:
        raise AssertionError(f"remat: the states after the pair differ by {worst} (relative)")
    return {"off": off["peak"], "on": on["peak"]}


CLI_TREE = (12, 2)  # train and valid scans: 6 labeled (split 1, 50%), 3 steps an epoch
TEST_RUNS = {"e": "d", "i": "h"}  # a `--test` run -> the training run whose state it reads
SWEEP_RUNS = {"p": "o"}  # a threshold-sweep run -> the training run whose state it reads
# Stage 2 at MinkUNet50 (f32): at batch 4 (2 + 2 scans, ~123k voxels a side)
# cap0 must reach ~250k, where the predicted peak (~91-101 GiB) does not fit
# the card; at batch 2 (1 + 1 scans) the largest cap0 predicted to fit with a
# margin (~67 GiB): PERF.md section 5
F6_CAP0 = 184_320


def cli_runs(root: Path) -> list:
    """(tag, argv, what it must show) of the CLI phase: every run through
    `python -m gcdlss_tpu_torch.main`'s `main(argv)`, f32 (the CLI's only
    dtype), at 0.05 m voxels and 80k points a scan."""
    ck, s1 = root / "ck", str(root / "ck" / "s1")
    common = ["--dataset", "SemanticKITTI", "-s", "1", "--dataset_path", str(root / "kitti"),
              "--voxel_size", str(VOXEL_SIZE), "--downsampling", str(POINTS_PER_SCAN),
              "--num_workers", "2", "--checkpoint_dir", str(ck), "--log_dir",
              str(root / "logs"), "--split_dir", str(root / "split"), "--device", "cuda"]
    s1_args = ["--module", "ExpPretrain", "--arch", "MinkUNet34", "--batch_size", str(BATCH),
               "--voxel_cap", str(CAP0), "--experiment", "s1"]

    def variant(module: str, experiment: str) -> list:
        return ["--module", module, "--batch_size", str(2 * BATCH), "--voxel_cap", str(S2_CAP0),
                "--experiment", experiment]

    s2_args = variant("ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive", "s2")
    return [
        ("a", common + s1_args + ["--epochs", "2"], "Stage 1, 2 epochs"),
        ("b", common + s1_args + ["--epochs", "3", "--resume_checkpoint", "1"],
         "Stage 1 resumed at epoch 2"),
        ("c", common + ["--module", "ExpMixExtraFineTuning", "--pretrained", s1, "--batch_size",
                        str(2 * BATCH), "--voxel_cap", str(S2_CAP0), "--experiment", "s15",
                        "--epochs", "1"], "Stage 1.5 from the handoff"),
        ("d", common + s2_args + ["--pretrained", s1, "--epochs", "1"],
         "Stage 2 from the handoff"),
        ("e", common + s2_args + ["--test", "--checkpoint", str(ck / "s2")],
         "Stage 2 --test on (d)'s state"),
        ("f", common + ["--module", "ExpPretrain", "--arch", "MinkUNet50", "--batch_size",
                        str(BATCH), "--voxel_cap", str(CAP0), "--experiment", "s1m50",
                        "--epochs", "1"], "Stage 1 at MinkUNet50"),
        ("g", common + variant("ExpMixRealMeanTeacherDiscover", "s2sk") + ["--pretrained", s1,
                                                                          "--epochs", "1"],
         "Stage 2, Sinkhorn assigner, from the handoff"),
        ("h", common + variant("ExpMergeDiscover_LaserMix_LiON_MeanTeacher", "s2lion")
         + ["--pretrained", s1, "--epochs", "1"], "Stage 2, LiON, from the handoff"),
        ("i", common + variant("ExpMergeDiscover_LaserMix_LiON_MeanTeacher", "s2lion")
         + ["--test", "--checkpoint", str(ck / "s2lion")], "Stage 2 LiON --test on (h)'s state"),
        ("j", common + variant("ExpMergeDiscover_PolarMix_MeanTeacher", "s2pm")
         + ["--pretrained", s1, "--epochs", "1"], "Stage 2, PolarMix-MT, from the handoff"),
        ("k", common + variant("ExpDiscover", "nops") + ["--pretrained", s1, "--epochs", "1"],
         "ExpDiscover from the handoff"),
        ("l", common + variant("ExpMixDiscoverSwaV", "swav") + ["--pretrained", s1,
                                                               "--epochs", "1"],
         "ExpMixDiscoverSwaV from the handoff"),
        ("m", common + variant("ExpDiscover", "nops") + ["--pretrained", s1, "--epochs", "2",
                                                        "--resume_checkpoint", "1"],
         "ExpDiscover resumed at epoch 1"),
        ("n", common + ["--module", "ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive",
                        "--arch", "MinkUNet50", "--batch_size", str(BATCH), "--voxel_cap",
                        str(F6_CAP0), "--experiment", "s2m50", "--pretrained",
                        str(ck / "s1m50"), "--epochs", "1"],
         f"Stage 2 at MinkUNet50 from (f)'s handoff, batch {BATCH}, cap0 {F6_CAP0}"),
        ("o", common + variant("ExpClusterFineTuning", "s15cl") + ["--pretrained", s1,
                                                                  "--epochs", "1"],
         "ExpClusterFineTuning from the handoff"),
        ("p", common + variant("ExpMixExtraTest", "s15cl") + ["--checkpoint", str(ck / "s15cl")],
         "ExpMixExtraTest's subdivided sweep on (o)'s state"),
    ]


def cli_phase(device, card: str) -> dict:
    """The port's CLI as a user runs it (`cli_runs`): on one synthetic
    SemanticKITTI tree, Stage 1 with a checkpoint an epoch and its handoff,
    a resume, Stage 1.5 and Stage 2 warm-started from it, `--test` on Stage
    2's saved state, Stage 1 at MinkUNet50, the Sinkhorn, LiON (then
    `--test`) and PolarMix-MT recipes from the handoff, ExpDiscover (then
    resumed at epoch 1) and ExpMixDiscoverSwaV from it, Stage 2 at
    MinkUNet50 from (f)'s handoff, ExpClusterFineTuning and ExpMixExtraTest's
    subdivided sweep on its state. Each run: finite losses, no plan dropping
    a voxel, K1 and K3 launched (K2 in every training run), K4 not; each
    `--test` gives its training run's last mIoU; each sweep scores every
    threshold. Then `clustering_eval_check` on (d)'s saved state. Returns the
    launches per run and in all."""
    import torch

    from gcdlss_tpu_torch import main as cli
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
    from gcdlss_tpu_torch.ops.plan_kernel import cube_candidates_map, cube_neighbor_map

    kernels = {"K1": gather_gemm, "K2": gather_gemm_backward, "K3": cube_neighbor_map,
               "K4": cube_candidates_map, **{k: v for k, v in part_kernels().items()
                                             if k != "K1"}}
    launches, records = {}, {}
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp, PlanProbe() as probe:
        root = Path(tmp)
        write_kitti_tree(root / "kitti", np.random.default_rng(8), *CLI_TREE)
        for tag, argv, what in cli_runs(root):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in kernels.values():
                fn.launches = 0
            if tag == "n":  # the F6 run: the card's memory as free as the process can make it
                torch.cuda.empty_cache()
            rec = records[tag] = cli.main(argv)
            torch.cuda.synchronize()
            launches[tag] = {name: fn.launches for name, fn in kernels.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            seen = probe.read()
            plans = len(seen["main"]) + len(seen["mix"])
            dropped = int(sum(seen["main"]) + sum(seen["mix"]) + sum(seen["quantize"]))
            module = rec["module"]
            steps = getattr(module, "step_log", [])
            for i, st in enumerate(steps):
                ms = st["step_ms"] if "step_ms" in st else st["seconds"] * 1e3
                clock = "device time" if "step_ms" in st else "host time"
                log(f"cli ({tag}) step {i}: loss {st['loss']:.6f} | {clock} {ms:.1f} ms ({card})")
            for h in rec["history"]:
                log(f"cli ({tag}) epoch {h['epoch']}: " + " ".join(
                    f"{k} {v:.6f}" for k, v in h.items()
                    if k in ("train/loss", "valid/mIoU", "valid/mIoU_old", "valid/mIoU_new")))
            log(f"cli ({tag}) {what}: {len(steps)} steps, start epoch {rec['start_epoch']}, "
                f"{plans} plans dropped {dropped} voxels; peak memory {peak:.3f} GiB ({card}); "
                f"wall {time.perf_counter() - t0:.1f} s; launches {launches[tag]}")
            train = tag not in TEST_RUNS and tag not in SWEEP_RUNS
            bad = [(i, k) for i, st in enumerate(steps) for k, v in st.items()
                   if isinstance(v, float) and not np.isfinite(v)]
            if train and (not steps or bad):
                raise AssertionError(f"cli ({tag}): {len(steps)} steps, non-finite {bad}")
            if dropped or not plans:
                raise AssertionError(f"cli ({tag}): {plans} plans dropped {dropped} voxels")
            need = ("K1", "K2", "K3") if train else ("K1", "K3")
            if not all(launches[tag][k] > 0 for k in need) or launches[tag]["K4"]:
                raise AssertionError(f"cli ({tag}): launches {launches[tag]}, need {need}, no K4")
        ck = root / "ck"
        saved = {run: sorted(p.name for p in (ck / run).iterdir()) for run in ("s1", "s2", "nops")}
        clustering_eval_check(device, card, records["e"]["module"], root)
    log(f"cli: saved {saved}")
    if saved["s1"] != ["0", "1", "2", "pretrained"]:
        raise AssertionError(f"cli: Stage 1 saved {saved['s1']}, expected epochs 0-2 + pretrained")
    if [h["epoch"] for h in records["a"]["history"]] != [0, 1] or \
            [h["epoch"] for h in records["b"]["history"]] != [2]:
        raise AssertionError("cli: (a) must run epochs 0, 1 and (b) epoch 2 alone")
    if [h["epoch"] for h in records["m"]["history"]] != [1] or \
            saved["nops"] != ["0", "1", "pretrained"]:
        raise AssertionError(f"cli: (m) must resume ExpDiscover at epoch 1 alone; saved "
                             f"{saved['nops']}")
    for tag in ("k", "l", "m"):
        log(f"cli ({tag}): " + " ".join(
            f"{k} {[int(st[k]) for st in records[tag]['module'].step_log]}"
            for k in ("n_cand", "n_rel", "has_novel", "n_match")
            if k in records[tag]["module"].step_log[0]))
    for sweep, run in SWEEP_RUNS.items():
        res = records[sweep]["result"]
        log(f"cli ({sweep}) on ({run})'s state: " + " ".join(
            f"{t}: {r['mIoU']:.6f}/{r['mIoU_new']:.6f}" for t, r in sorted(res.items())))
        if len(res) != 7 or not all(r["conf"].sum() > 0 for r in res.values()):
            raise AssertionError(f"cli ({sweep}): the sweep scored {len(res)} thresholds")
    log(f"cli (d): has_novel {[st['has_novel'] for st in records['d']['module'].step_log]}, "
        f"n_cand {[st['n_cand'] for st in records['d']['module'].step_log]}")
    for test, run in TEST_RUNS.items():
        last = records[run]["history"][-1]["valid/mIoU"]
        tested = records[test]["result"]["mIoU"]
        log(f"cli: ({run})'s last validate mIoU {last!r}, ({test})'s --test mIoU {tested!r}")
        if tested != last:
            raise AssertionError(f"cli: --test on ({run})'s state gives mIoU {tested}, ({run}) "
                                 f"gave {last}")
    launches["total"] = {k: sum(run[k] for run in launches.values()) for k in kernels}
    return launches


FEATURE_TOL = REF_TOL  # relative Frobenius error of the card's features against the CPU's
CMP_POINTS = 20_000  # points of the valid scan whose features the card and the CPU both extract
# the clustering on the card against the same clustering on the CPU, on the
# card's features: equal confusion matrices, or (a distance within f32
# rounding of a tie sends a voxel to the other cluster; each such voxel moves
# one count between two cells) at most CLUSTER_MOVED_TOL of the voxels in
# other cells and the mIoU within CLUSTER_MIOU_TOL
CLUSTER_MOVED_TOL = 1e-3
CLUSTER_MIOU_TOL = 5e-3


def clustering_eval_check(device, card: str, module, root: Path) -> dict:
    """The offline clustering evaluation (`eval/clustering_eval`) over a
    saved Stage-2 state (`module`, whose state `--test` restored): the
    teacher's backbone features of the valid scans extracted on the card
    (`extract_features`, 2 scans a batch at the Stage-2 caps), and those of
    the first training scan cut to CMP_POINTS points on the card and on the CPU
    (plain versions, the forward conv's operands rounded to bf16 as the
    card's f32 model does; the CPU takes ~49 s for one whole 80k-point
    scan), within FEATURE_TOL; then `clustering_discovery_eval` with `semi_kmeans` and
    `sinkhorn` on the card's features, on the card and on the CPU, with the
    same draws: confusion matrices equal, or within CLUSTER_MOVED_TOL /
    CLUSTER_MIOU_TOL. Prints each call's host time. Returns the results."""
    import copy

    import torch

    from gcdlss_tpu_torch.data import PrefetchLoader, SemanticKITTIDataset
    from gcdlss_tpu_torch.eval.clustering_eval import clustering_discovery_eval, extract_features
    from gcdlss_tpu_torch.ops import conv as plain
    from gcdlss_tpu_torch.ops import fused_conv
    from gcdlss_tpu_torch.train.common import default_caps, plan_and_gather, voxel_batch_to_device

    unknown, mapping, inv, unk = label_space()
    cfg = module.cfg
    val_ds = SemanticKITTIDataset(str(root / "kitti"), "valid", voxel_size=VOXEL_SIZE,
                                  label_mapping=mapping, unknown_labels=unknown)
    models = {"cuda": module.state.teacher, "cpu": copy.deepcopy(module.state.teacher).cpu()}

    def forward(dev, caps):
        @torch.no_grad()
        def fwd(batch):
            model = models[dev]
            model.eval()
            vb = voxel_batch_to_device(batch["voxel"], dev)
            plan, feats0, labels0, mapped0 = plan_and_gather(vb, caps)
            return model(plan, feats0)["feats"], mapped0, labels0, plan.levels[0].valid
        return fwd

    def card_rounding(x, nbr, w, out_dtype=torch.float32):
        return plain.gather_conv(x.bfloat16().float(), nbr, w.bfloat16().float(), out_dtype)

    def extract(dev, dataset, scans, caps, max_voxels):
        loader = PrefetchLoader(dataset, scans, caps[0], shuffle=False, num_workers=2,
                                drop_last=False)
        orig = fused_conv.gather_conv
        fused_conv.gather_conv = card_rounding if dev == "cpu" else orig
        try:
            t0 = time.perf_counter()
            out = extract_features(forward(dev, caps), loader, cfg.feat_dim, max_voxels)
            log(f"clustering eval: extract_features on {dev}, {scans} scan(s) a batch: "
                f"{out[0].shape[0]} voxels, {time.perf_counter() - t0:.2f} s")
            return out
        finally:
            fused_conv.gather_conv = orig

    # a random CMP_POINTS-point draw of the first training scan (the same on
    # both devices: per-scan seeds), rotated and scaled as in training
    cut = SemanticKITTIDataset(str(root / "kitti"), "train", split_indices=np.arange(1),
                               labeled=True, voxel_size=VOXEL_SIZE, downsampling=CMP_POINTS,
                               augment=True, seed=0, label_mapping=mapping,
                               unknown_labels=unknown)
    cut_caps = default_caps(22_528)
    (f1, m1, l1), (fp, mp, lp) = (extract(dev, cut, 1, cut_caps, 1) for dev in ("cuda", "cpu"))
    feat_err = float(np.linalg.norm(f1 - fp) / max(np.linalg.norm(fp), 1e-12))
    if not (np.array_equal(m1, mp) and np.array_equal(l1, lp)) or not feat_err <= FEATURE_TOL:
        raise AssertionError(f"clustering eval: card features off the CPU's by {feat_err:.3e} "
                             f"(tolerance {FEATURE_TOL}), labels equal {np.array_equal(m1, mp)}")
    fc, mc, lc = extract("cuda", val_ds, 2, cfg.voxel_caps, 2_000_000)
    known = [k for k, v in mapping.items() if v != unk]
    novel = [k for k, v in mapping.items() if v == unk]
    out = {"feature_err": feat_err}
    rng = np.random.default_rng(0)
    n_unknown = int((mc == unk).sum())
    for method in ("semi_kmeans", "sinkhorn"):
        # the same draws on both devices: the k-means++ rows after the known
        # anchors (semi_kmeans), the k-means initial-row scores (sinkhorn)
        kw = (dict(picks=rng.choice(n_unknown, len(novel), replace=False))
              if method == "semi_kmeans" else dict(scores=rng.random(n_unknown).astype(np.float32)))
        res = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res[dev] = clustering_discovery_eval(fc, mc, lc, unk, known, novel, 19, inv,
                                                 method=method, device=dev, **kw)
            res[dev]["host_s"] = time.perf_counter() - t0
        moved = int(np.abs(res["cuda"]["conf"] - res["cpu"]["conf"]).sum()) // 2
        total = int(res["cpu"]["conf"].sum())
        d_miou = abs(res["cuda"]["mIoU"] - res["cpu"]["mIoU"])
        out[method] = dict(
            mIoU={d: res[d]["mIoU"] for d in res}, mIoU_new={d: res[d]["mIoU_new"] for d in res},
            host_s={d: round(res[d]["host_s"], 3) for d in res}, moved=moved, voxels=total)
        log(f"clustering eval {method} ({card}): {json.dumps(out[method])}; card features "
            f"off the CPU's by {feat_err:.3e}")
        if not (moved == 0 or (moved <= CLUSTER_MOVED_TOL * total
                               and d_miou <= CLUSTER_MIOU_TOL)):
            raise AssertionError(f"clustering eval {method}: card and CPU differ: {moved} of "
                                 f"{total} voxels moved, mIoU {out[method]['mIoU']}")
    return out


def discovery_phase(device, card: str) -> dict:
    """The port's end-to-end discovery quality (`tools/discovery_quality.py`,
    the twin of the JAX package's tool): Stage 1 (12 epochs) and the
    default Stage-2 recipe (15 epochs) through the CLI on the learnable
    synthetic tree (2 sequences x 24 scans x 4,000 points, 8 valid;
    MinkUNet14, 0.15 m, cap 4,096, batch 2), on the card; the port's curves
    beside the JAX package's. Fails unless the tool's `check` passes (last
    Stage-2 mIoU_new >= 0.10, best mIoU_old above the first) or a kernel of
    the path was not launched. Returns the kernels' launches."""
    import torch

    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
    from gcdlss_tpu_torch.ops.plan_kernel import cube_candidates_map, cube_neighbor_map
    from gcdlss_tpu_torch.tools import discovery_quality as dq

    kernels = {"K1": gather_gemm, "K2": gather_gemm_backward, "K3": cube_neighbor_map,
               "K4": cube_candidates_map}
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = dq.run(str(Path(tmp) / "dq"), device=str(device), num_workers=4)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
    jax_curves = json.loads(dq.JAX_CURVES.read_text()) if dq.JAX_CURVES.exists() else {}
    log(f"discovery quality ({card}; {time.perf_counter() - t0:.1f} s): {json.dumps(result)}")
    for line in dq.side_by_side(result, jax_curves).splitlines():
        log(f"discovery quality: {line}")
    faults = dq.check(result)
    log(f"discovery quality: launches {launches}; "
        f"{'discovers' if not faults else 'FAILS: ' + '; '.join(faults)}")
    if faults:
        raise AssertionError(f"discovery quality: {faults}")
    if not all(launches[k] > 0 for k in ("K1", "K2", "K3")) or launches["K4"]:
        raise AssertionError(f"discovery quality: launches {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gcdlss_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]  # name, power limit
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    gpu_name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {gpu_name}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {lib_path.name} ready in {time.perf_counter() - t0:.2f} s")

    wall = {}

    def phase(name: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        wall[name] = time.perf_counter() - t
        log(f"phase {name}: {wall[name]:.1f} s wall")
        return out

    phase("rates", rates_phase, device)
    rows = phase("kernels", kernel_phase, device) + phase("stage2 kernels", stage2_kernel_phase,
                                                          device)
    phase("adversarial", adversarial_phase, device)
    phase("K3 adversarial", cube_map_adversarial_phase, device)
    phase("K4 adversarial", cube_candidates_adversarial_phase, device)
    phase("reference bf16", reference_phase, device, "bfloat16")
    phase("reference f32", reference_phase, device, "float32")
    phase("plan sync", plan_sync_phase, device)
    part_rows, launches_parts = phase("conv parts", conv_parts_phase, device, card)
    launches_s1, s1_weights = phase("stage1", stage1_phase, device, gpu_name)
    launches_s15 = phase("stage1.5", stage15_phase, device, card, s1_weights)
    launches_s2 = phase("stage2", stage2_phase, device, gpu_name)
    launches_var = phase("stage2 variants", stage2_variants_phase, device, card)
    peaks_remat = phase("remat", remat_phase, device, card)
    launches_nops = phase("nops", nops_phase, device, card)
    launches_cli = phase("cli", cli_phase, device, card)
    launches_dq = phase("discovery quality", discovery_phase, device, card)
    log(f"phases (wall s): {json.dumps({k: round(v, 1) for k, v in wall.items()})}; "
        f"remat peaks (GiB) {peaks_remat}")
    # `launches`: K1-K4 on the Stage-2 path (the training path that runs all
    # four; `launches_stage1` the Stage-1 path, `launches_stage15` the
    # Stage-1.5 phase, `launches_variants` the Stage-2 variants together,
    # `launches_nops` the four single-model recipes together, `launches_cli`
    # the CLI's sixteen runs together, `launches_quality` the discovery-quality
    # run), P1-P4 in
    # the tool's main run (their only path; K1's launches there are
    # `launches_parts`)
    for r in rows:
        r["launches"] = launches_s2[r["name"][:2]]
        r["launches_stage1"] = launches_s1[r["name"][:2]]
        r["launches_stage15"] = launches_s15["total"][r["name"][:2]]
        r["launches_variants"] = launches_var["total"][r["name"][:2]]
        r["launches_nops"] = launches_nops["total"][r["name"][:2]]
        r["launches_quality"] = launches_dq[r["name"][:2]]
        if r["name"][:2] == "K1":
            r["launches_parts"] = launches_parts["K1"]
    for r in part_rows:
        r["launches"] = launches_parts[r["name"][:2]]
    rows += part_rows
    for r in rows:
        r["launches_cli"] = launches_cli["total"][r["name"][:2]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    extra = ("launches_stage1", "launches_stage15", "launches_variants", "launches_nops",
             "launches_cli", "launches_quality", "launches_parts",
             "bound_measured_ms",
             "bound_dense_ms", "fill",
             "far_entries",
             "strips_kept", "pairs", "dw_only_ms", "ranks_plus_kernel_ms", "k3_ms")
    missing = [(r["name"], k) for r in rows for k in keys if k not in r]
    if missing:
        raise AssertionError(f"kernel rows lack keys: {missing}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": gpu_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
