#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gcdlss_tpu_torch`) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

or, for one of the last three phases alone after the build and the rates
(no kernels line, no last line), `python3 chip_smoke.py --only library`,
`--only dp` or `--only sp`.

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
  8c. Cylinder3D (`cylinder_phase`): K3 at every level of a cylinder plan
     (the VFE's voxels of a Stage-2 batch, caps `cylinder_caps(S2_CAP0)`)
     bit for bit against the join path, K1/K2 on its K = 9, 3 and 27
     subset books at 64 and 512 channels and on its paired strided books
     ((2, 2, 2) and (2, 2, 1), both role orders), `pool_conv` against the
     plain `paired_gather_conv`; then Stage 2 on `Cylinder3DRC` at the
     `bench.py` configuration (f32, 3 steps + validate; device and host step
     times, peak memory, launches a step, each cylinder plan's unique voxels
     per level against its caps, candidates, `has_novel`), the supervised
     trainer at `CylinderConfig`'s defaults (3 steps + eval) and
     `Cylinder3DRC` on a small input, card against CPU;
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
     subdivided sweep on (o)'s state; (q) Stage 2 with `--arch Cylinder3D`
     (one epoch, fresh weights) and (r) `--test` on its state, whose mIoU
     must equal (q)'s. Every run: finite losses, no
     plan (train or eval) dropping a voxel, K1 and K3 launched (K2 in every
     training run), K4 not; step times, peak memory and the card printed.
     Then the offline clustering evaluation on (d)'s saved state, card
     against CPU (`clustering_eval_check`);
 10. discovery quality (`discovery_phase`): `tools/discovery_quality.py` on
     the card, Stage 1 (12 epochs) then the default Stage-2 recipe (15) on
     the learnable synthetic tree through the CLI; fails unless the last
     mIoU_new reaches 0.10 and the best mIoU_old exceeds the first;
 11. library models (`library_phase`): one plan at the Stage-2 shapes; K1/K2
     at the mmdet3d backbone's new shapes (k3 stem 1 -> 32 at L0, 384 -> 256
     at L3, 128 -> 96 at L0) against their plain versions; then a
     train-mode forward + backward (CE + SupCon + DINO distillation) of
     MultiHeadMinkUnet18 at its reference widths and of every wrapper and
     ORCA model at its default planes (step ms, peak, launches), and in
     eval mode their outputs with the kernels against the same model on the
     plain versions on the card, relative <= REF_TOL, the gradients within
     GRAD_TOL, and as a vector and leaf by leaf no farther from the f32
     gradient than the plain route's (F32_TOL);
 12. data parallelism (`dp_phase`): (a) one NCCL rank in this process, the
     Stage-1 and Stage-2 steps with the group bit for bit those without;
     (b) two processes on the card over gloo with CUDA tensors, 1 + 1
     scans each, against the one-process 2 + 2 step: the ranks the same
     bits, on a plain f32 route counts equal and states within the CPU
     test's tolerances, on the kernels (bf16) losses, counts and states
     within DP_BF16_TOL;
 13. voxel sharding (`sp_phase`): (a) two processes on the card over gloo
     with CUDA tensors, each holding the whole batch and half of every
     level's rows (`parallel.sp_step`, `parallel.sp_discover`: halo
     exchange, K1 forward and K2 backward over window books, K3 for the
     plan every rank builds), Stage 1 (2 scans) and Stage 2 (2 + 2 scans)
     on the kernels and on a plain f32 route against the one-process step,
     then the sharded subm, down and up convs of one Stage-2 level each
     against their plain versions (K1/K2 on the window books as kernel
     rows); (b) four processes, dp 2 x sp 2, Stage 1 against the
     one-process step on the union batch. Prints the halos, window rows,
     overflows (all 0), worst state differences, step ms a rank and each
     rank's K1/K2/K3 launches; ranks the same bits, the plain route within
     the CPU tests' tolerances, the kernels within SP_BF16_TOL.
  Phase 2 also holds K1/K2 at MinkUNet50's pool-conv widths (downs 128,
  256, 512 channels; ups 1,024 -> 256, 1,024 -> 128, 512 -> 96, 384 -> 96)
  on the Stage-1 plan, and phase 4 runs the reference forward in bf16 and
  in f32 (the f32 model's convs round x and W to bf16 on the card and keep
  f32 sums). Each phase's wall time is printed.

Each path (the tool's `main`, the Stage-1 slice, each run of the Stage-1.5
slice, the Stage-2 slice, each Stage-2 variant, each single-model recipe,
Cylinder3D's Stage-2 run and its trainer, each CLI run, the
discovery-quality run, each library model's step, the data-parallel runs,
the voxel-sharded ranks' runs) sets every kernel's launch count to
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

import contextlib
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
TEST_RUNS = {"e": "d", "i": "h", "r": "q"}  # a `--test` run -> the run whose state it reads
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
        ("q", common + s2_args[:-1] + ["s2cyl", "--arch", "Cylinder3D", "--epochs", "1"],
         "Stage 2 on Cylinder3D"),
        ("r", common + s2_args[:-1] + ["s2cyl", "--arch", "Cylinder3D", "--test",
                                       "--checkpoint", str(ck / "s2cyl")],
         "Stage 2 Cylinder3D --test on (q)'s state"),
    ]


def cli_phase(device, card: str) -> dict:
    """The port's CLI as a user runs it (`cli_runs`): on one synthetic
    SemanticKITTI tree, Stage 1 with a checkpoint an epoch and its handoff,
    a resume, Stage 1.5 and Stage 2 warm-started from it, `--test` on Stage
    2's saved state, Stage 1 at MinkUNet50, the Sinkhorn, LiON (then
    `--test`) and PolarMix-MT recipes from the handoff, ExpDiscover (then
    resumed at epoch 1) and ExpMixDiscoverSwaV from it, Stage 2 at
    MinkUNet50 from (f)'s handoff, ExpClusterFineTuning and ExpMixExtraTest's
    subdivided sweep on its state, Stage 2 with `--arch Cylinder3D` and
    `--test` on its state. Each run: finite losses, no plan dropping
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


class CylPlanProbe:
    """Inside, every cylinder plan a model builds (`models.cylinder3d.
    build_cyl_plan`) records its levels' unique counts, on the device, and
    its caps, for `read`."""

    def __enter__(self):
        from gcdlss_tpu_torch.models import cylinder3d

        self.mod, self.orig, self.seen = cylinder3d, cylinder3d.build_cyl_plan, []

        def probe(coords, valid, caps, *args):
            import torch

            plan = self.orig(coords, valid, caps, *args)
            self.seen.append((torch.stack([lvl.count for lvl in plan.levels]), tuple(caps)))
            return plan

        cylinder3d.build_cyl_plan = probe
        return self

    def __exit__(self, *exc):
        self.mod.build_cyl_plan = self.orig

    def read(self) -> list:
        """(counts, caps) of each plan since the last read, on the host."""
        seen, self.seen = self.seen, []
        return [(c.tolist(), caps) for c, caps in seen]


def cylinder_kernel_rows(device) -> list:
    """K3, K1/K2 and the paired strided conv at Cylinder3D's shapes, on the
    cylinder plan of a Stage-2 combined batch (2 + 2 scans, cap0 S2_CAP0;
    the VFE's cylindrical voxels at `cylinder_caps(S2_CAP0)`): K3 at every
    level bit for bit against the join path (rows with times for L0 and
    L3); K1/K2 (`gemm_phase`) on the K = 9 and K = 3 subset books at 64
    channels (L0) and 512 (L3), the full 27 at L3, and the 27-column paired
    books of a (2, 2, 2) and a (2, 2, 1) edge in both role orders; then
    `pool_conv` (the model's autograd route: f32 in, bf16 operands) forward
    and backward against the plain `paired_gather_conv` on the same
    bf16-rounded inputs, relative error <= DW_TOL."""
    import torch

    from gcdlss_tpu_torch.models.cylinder3d import SegVFE, build_cyl_plan, cylinder_caps
    from gcdlss_tpu_torch.ops import conv as plain
    from gcdlss_tpu_torch.ops.coords import encode_coords
    from gcdlss_tpu_torch.ops.fused_conv import pool_conv
    from gcdlss_tpu_torch.ops.plan import join_neighbor_map
    from gcdlss_tpu_torch.ops.plan_kernel import cube_neighbor_map

    coords, valid = voxel_batch(np.random.default_rng(3), device, sides=2)
    caps = cylinder_caps(S2_CAP0)
    vfe = SegVFE(1, generator=torch.Generator().manual_seed(0)).to(device).eval()
    with torch.no_grad():
        vox = vfe(coords[:, 1:4].float() * torch.tensor(VOXEL_SIZE, device=device),
                  torch.ones(coords.shape[0], 1, device=device), coords[:, 0], valid, caps[0])
        plan = build_cyl_plan(vox["coords"], vox["valid"], caps)
    lv, edges = plan.levels, plan.edges
    log(f"cylinder kernel plan: caps {caps}, unique voxels {[int(lvl.count) for lvl in lv]}")
    rows = []
    for i, lvl in enumerate(lv):
        kh, kl = encode_coords(lvl.coords, lvl.valid)
        got, ref = cube_neighbor_map(kh, kl, 3), join_neighbor_map(kh, kl, 3)
        mism = int((got != ref).sum()) + int((got != lvl.nbr27).sum())
        if mism:
            raise AssertionError(f"K3 cylinder L{i}: {mism} entries differ from the join path")
        if i in (0, 3):
            ms = cuda_time_ms(lambda: cube_neighbor_map(kh, kl, 3))
            pms = cuda_time_ms(lambda: join_neighbor_map(kh, kl, 3))
            log(f"K3 cylinder L{i} k3: cap {kh.shape[0]}, bit for bit | kernel {ms:.3f} ms, "
                f"plain {pms:.3f} ms")
            rows.append(dict(name=f"K3 cube_map cylinder L{i} k3", route="cuda",
                             source="gcdlss_tpu_torch/csrc/cube_map.cu",
                             replaces="gcdlss_tpu/ops/plan_kernel.py:378", max_abs_err=0.0,
                             ms=ms, plain_ms=pms, **bound(nbytes(kh, kl, got), 0)))

    def subm(i, shape, ch):
        book = lv[i].books[shape]
        return (f"L{i} {''.join(map(str, shape))} K{book.shape[1]} {ch}->{ch}", lv[i].valid,
                book, book.flip(1).contiguous(), ch, ch)

    edge_cases = ((0, "(2,2,2)", 64), (3, "(2,2,1)", 512))
    cases = [subm(0, (1, 3, 3), 64), subm(0, (3, 1, 1), 64), subm(3, (1, 3, 3), 512),
             subm(3, (1, 1, 3), 512), subm(3, (3, 3, 3), 512)]
    pairs = []
    for e, stride, ch in edge_cases:
        pairs += [(f"E{e} down {stride} {ch}->{ch}", lv[e].valid, edges[e].down_map,
                   edges[e].up_map, ch, ch),
                  (f"E{e} up {stride} {ch}->{ch}", lv[e + 1].valid, edges[e].up_map,
                   edges[e].down_map, ch, ch)]
    rows += gemm_phase(None, device, "cylinder", cases + pairs)

    gen = torch.Generator(device=device).manual_seed(7)
    for name, xvalid, fwd, adj, ch, _ in pairs:
        x = (torch.randn(xvalid.shape[0], ch, generator=gen, device=device)
             * xvalid[:, None]).bfloat16().float()
        w = (torch.randn(27, ch, ch, generator=gen, device=device) / (27 * ch) ** 0.5
             ).bfloat16().float()
        g = torch.randn(fwd.shape[0], ch, generator=gen, device=device).bfloat16().float()
        outs = []
        for fn in (pool_conv, plain.paired_gather_conv):
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            out = fn(xg, fwd, adj, wg)
            out.backward(g)
            outs.append((out.detach(), xg.grad, wg.grad))
        rel = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
               for a, b in zip(*outs)]
        log(f"pool_conv cylinder {name}: out, dX, dW rel-Frobenius {rel[0]:.3e} {rel[1]:.3e} "
            f"{rel[2]:.3e} against paired_gather_conv")
        if not max(rel) <= DW_TOL:
            raise AssertionError(f"pool_conv cylinder {name}: relative errors {rel}")
    return rows


def cylinder_card_vs_cpu(device, card: str) -> None:
    """`Cylinder3DRC` (f32, eval-mode batch norm) on a small input on the card
    (kernels) and on the CPU (plain versions, the forward conv rounding its
    operands to bf16 as the card does), the same weights: the four outputs
    and the head's CE and Lovasz parts within REF_TOL (relative)."""
    import copy

    import torch

    from gcdlss_tpu_torch.models.cylinder3d import Cylinder3DHead, Cylinder3DRC
    from gcdlss_tpu_torch.ops import conv as plain
    from gcdlss_tpu_torch.ops import fused_conv
    from gcdlss_tpu_torch.ops.plan import build_unet_plan
    from gcdlss_tpu_torch.train.common import default_caps

    rng = np.random.default_rng(5)
    cap0 = 8192
    pts = rng.uniform([-12, -12, -2], [12, 12, 1], (6000, 3)).astype(np.float32)
    q = np.unique(np.floor(pts / VOXEL_SIZE).astype(np.int32), axis=0)
    coords = np.zeros((cap0, 4), np.int32)
    coords[:len(q), 1:] = q
    valid = np.arange(cap0) < len(q)
    feats = rng.uniform(0, 1, (cap0, 1)).astype(np.float32) * valid[:, None]
    labels = np.where(valid, rng.integers(0, 17, cap0), -1)
    model = Cylinder3DRC(17, 2, generator=torch.Generator().manual_seed(0)).eval()

    def card_rounding(x, nbr, w, out_dtype=torch.float32):
        return plain.gather_conv(x.bfloat16().float(), nbr, w.bfloat16().float(), out_dtype)

    outs, orig = {}, fused_conv.gather_conv
    for dev, m in ((torch.device("cpu"), model), (device, copy.deepcopy(model).to(device))):
        fused_conv.gather_conv = card_rounding if dev.type == "cpu" else orig
        try:
            with torch.no_grad():
                plan = build_unet_plan(torch.as_tensor(coords, device=dev),
                                       torch.as_tensor(valid, device=dev), default_caps(cap0))
                out = m(plan, torch.as_tensor(feats, device=dev))
                _, parts = Cylinder3DHead.loss(out["logits_known"],
                                               torch.as_tensor(labels, device=dev),
                                               plan.levels[0].valid)
        finally:
            fused_conv.gather_conv = orig
        outs[dev.type] = {**{k: v.cpu() for k, v in out.items()},
                          **{k: v.cpu()[None] for k, v in parts.items()}}
    rel = {k: float(torch.linalg.vector_norm(outs["cuda"][k] - v) / torch.linalg.vector_norm(v))
           for k, v in outs["cpu"].items()}
    log(f"cylinder card vs CPU (Cylinder3DRC f32, {len(q)} voxels; {card}): relative "
        f"{json.dumps(rel)}; CE {float(outs['cuda']['ce']):.6f} (CPU "
        f"{float(outs['cpu']['ce']):.6f}), Lovasz {float(outs['cuda']['lovasz']):.6f} (CPU "
        f"{float(outs['cpu']['lovasz']):.6f})")
    if not all(np.isfinite(v) and v <= REF_TOL for v in rel.values()):
        raise AssertionError(f"cylinder card vs CPU: relative errors {rel} above {REF_TOL}")


def cylinder_stage2(device, card: str, kernels: dict, probe) -> dict:
    """Stage 2 on Cylinder3DRC at the `bench.py` configuration (2 + 2 scans
    of 80k points, cap0 S2_CAP0, cand_cap 4096, queue 20 x 1024 x 128, 15
    k-means rounds, the default recipe, f32): `train_epoch` over 3 step
    pairs, then `validate` on 4 scans."""
    import torch

    from gcdlss_tpu_torch.data import SemanticKITTIDataset
    from gcdlss_tpu_torch.train.common import default_caps
    from gcdlss_tpu_torch.train.discover import DiscoverConfig, make_discover_config
    from gcdlss_tpu_torch.train.modules import ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive

    caps = default_caps(S2_CAP0)
    unknown, mapping, inv, unk = label_space()
    cfg = DiscoverConfig(**make_discover_config(
        "SemanticKITTI", num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
        unknown_label=unk, voxel_caps=caps, sup_voxel_cap=CAP0, mix_voxel_caps=caps,
        num_sup_scans=BATCH, point_cap=POINTS_PER_SCAN, voxel_size=VOXEL_SIZE,
        arch="Cylinder3D", dtype="float32", cand_cap=4096, queue_slots=20, queue_per_slot=1024,
        kmeans_iters=15, steps_per_epoch=1000))
    common = dict(voxel_size=VOXEL_SIZE, downsampling=POINTS_PER_SCAN, augment=True,
                  label_mapping=mapping, unknown_labels=unknown)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = Path(tmp)
        write_kitti_tree(root, np.random.default_rng(6), 6 * BATCH, 2 * BATCH)
        split = np.arange(3 * BATCH)  # labeled; the other 3 * BATCH scans are the unlabeled
        lab = SemanticKITTIDataset(str(root), "train", split_indices=split, labeled=True,
                                   resize_aug=True, seed=0, **common)
        unlab = SemanticKITTIDataset(str(root), "train", split_indices=split, labeled=False,
                                     seed=1, **common)
        val_ds = SemanticKITTIDataset(str(root), "valid", voxel_size=VOXEL_SIZE,
                                      label_mapping=mapping, unknown_labels=unknown)
        module = ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive(cfg, mapping, inv, seed=0,
                                                                device=device)
        loaders = module.make_loaders(lab, unlab, num_workers=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        probe.read()
        for fn in kernels.values():
            fn.launches = 0
        module.train_epoch(*loaders)
        torch.cuda.synchronize()
        train = {name: fn.launches for name, fn in kernels.items()}
        plans = probe.read()
        vm = module.validate(val_ds, num_workers=2)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = module.step_log
    for i, s in enumerate(steps):
        terms = " ".join(f"{k} {s[k]:.6f}" for k in S2_LOSS_TERMS)
        log(f"cylinder stage2 step {i}: {terms} | tau {s['tau']:.6f} n_cand {s['n_cand']:.0f} "
            f"n_rel {s['n_rel']:.0f} has_novel {s['has_novel']:.0f} plan_overflow "
            f"{s['plan_overflow']:.0f} | device time {s['step_ms']:.1f} ms, host time "
            f"{s['seconds'] * 1e3:.1f} ms ({card})")
    # three cylinder plans a step: the teacher's, the student's, the mixed forward's
    for i, (counts, caps_) in enumerate(plans):
        log(f"cylinder stage2 plan {i}: unique voxels per level {counts} against caps {caps_}")
    per_step = {k: round(v / max(len(steps), 1), 2) for k, v in train.items()}
    log(f"cylinder stage2: validate mIoU {vm['mIoU']:.6f} old {vm['mIoU_old']:.6f} new "
        f"{vm['mIoU_new']:.6f} confusion sum {int(vm['conf'].sum())}; peak memory {peak:.3f} "
        f"GiB ({card}); launches a step {per_step}, with validate {launches}")
    if len(steps) != 3:
        raise AssertionError(f"cylinder stage2: {len(steps)} train steps, expected 3")
    bad = [(i, k) for i, s in enumerate(steps) for k in S2_LOSS_TERMS + ("tau",)
           if not np.isfinite(s[k])]
    if bad:
        raise AssertionError(f"cylinder stage2: non-finite (step, term): {bad}")
    if len(plans) != 3 * len(steps):
        raise AssertionError(f"cylinder stage2: {len(plans)} cylinder plans in 3 steps")
    if any(s["plan_overflow"] != 0 for s in steps):
        raise AssertionError("cylinder stage2: a UNet plan dropped voxels")
    if not any(s["has_novel"] == 1 for s in steps):
        raise AssertionError("cylinder stage2: the novel branch never fired")
    if not vm["conf"].sum() > 0:
        raise AssertionError("cylinder stage2: empty confusion matrix")
    if not all(train[k] > 0 for k in ("K1", "K2", "K3")) or launches["K4"]:
        raise AssertionError(f"cylinder stage2: launches {launches}, need K1-K3, no K4")
    return launches


def cylinder_train(device, card: str, kernels: dict, probe) -> dict:
    """The supervised Cylinder3D trainer at `CylinderConfig`'s defaults (2
    scans x 80k points, caps 65,536 .. 4,096): 3 `cylinder_train_step`s,
    then `cylinder_eval_step`."""
    import torch

    from gcdlss_tpu_torch.data import synth_scan_points
    from gcdlss_tpu_torch.train.common import inv_label_lut
    from gcdlss_tpu_torch.train.cylinder import (CylinderConfig, create_cylinder_state,
                                                 cylinder_eval_step, cylinder_train_step)

    _, _, inv, unk = label_space()
    cfg = CylinderConfig(num_labeled_classes=17, num_classes=19, unknown_label=unk)
    state = create_cylinder_state(0, cfg, device=device)
    rng = np.random.default_rng(9)
    s, p = cfg.num_scans, cfg.point_cap
    labels = rng.integers(0, 19, (s, p)).astype(np.int32)
    pts = {"xyz": torch.as_tensor(np.stack([synth_scan_points(rng, p) for _ in range(s)]),
                                  device=device),
           "feats": torch.as_tensor(rng.uniform(0, 1, (s, p, 3)).astype(np.float32),
                                    device=device),
           "labels": torch.as_tensor(labels, device=device),
           "mapped_labels": torch.as_tensor(np.minimum(labels, unk), device=device),
           "valid": torch.ones((s, p), dtype=torch.bool, device=device)}
    lut = torch.as_tensor(inv_label_lut(inv, 17), device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probe.read()
    for fn in kernels.values():
        fn.launches = 0
    metrics, times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = cylinder_train_step(state, pts, cfg)
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        metrics.append({k: float(v) for k, v in m.items()})
        times.append((start.elapsed_time(end), host))
    conf = cylinder_eval_step(state, pts, lut, cfg)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    plans = probe.read()
    for i, (m, (dev_ms, host_ms)) in enumerate(zip(metrics, times)):
        log(f"cylinder train step {i}: loss {m['loss']:.6f} ce {m['ce']:.6f} lovasz "
            f"{m['lovasz']:.6f} | device time {dev_ms:.1f} ms, host time {host_ms:.1f} ms "
            f"({card})")
    log(f"cylinder train: plan levels (unique voxels, caps) {plans[0]}; eval confusion sum "
        f"{int(conf.sum())}; peak memory {peak:.3f} GiB ({card}); launches {launches}")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"cylinder train: non-finite metrics {metrics}")
    if not int(conf.sum()) > 0:
        raise AssertionError("cylinder train: empty confusion matrix")
    if not all(launches[k] > 0 for k in ("K1", "K2", "K3")) or launches["K4"]:
        raise AssertionError(f"cylinder train: launches {launches}, need K1-K3, no K4")
    return launches


def cylinder_phase(device, card: str):
    """Cylinder3D on the card: its kernels at its shapes against their plain
    versions (`cylinder_kernel_rows`), then its two paths, each with every
    kernel's count set to 0 just before it and read just after: Stage 2 on
    Cylinder3DRC (`cylinder_stage2`) and the supervised trainer
    (`cylinder_train`); then `cylinder_card_vs_cpu`. Returns (kernel rows,
    launches per path and in all)."""
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
    from gcdlss_tpu_torch.ops.plan_kernel import cube_candidates_map, cube_neighbor_map

    kernels = {"K1": gather_gemm, "K2": gather_gemm_backward, "K3": cube_neighbor_map,
               "K4": cube_candidates_map}
    rows = cylinder_kernel_rows(device)
    with CylPlanProbe() as probe:
        launches = {"stage2": cylinder_stage2(device, card, kernels, probe),
                    "train": cylinder_train(device, card, kernels, probe)}
    cylinder_card_vs_cpu(device, card)
    launches["total"] = {k: sum(run[k] for run in launches.values()) for k in kernels}
    return rows, launches


# ---- the library models and loss zoo (library_phase)

LIBRARY_ROWS = 4096  # valid rows of the SupCon and distillation terms
# The library models' gradient, kernels vs plain on the card, relative:
# about twice the largest of the seven models' (bf16: MinkUnet34ORCA's
# 2.05e-2; f32 route: DualMinkUnet's 5.7e-3; three runs the same bits,
# NVIDIA H100 80GB HBM3, 700 W).
GRAD_TOL = {"bfloat16": 4e-2, "float32": 1.5e-2}
# The kernels' relative distance from the f32 gradient over the plain
# route's: the whole vector's at most `vector` times (measured: at most
# 1.045), each leaf's at most `leaf` times plus `floor` (measured: every
# leaf within 2x less 4e-4; the BN weights and biases of the deep blocks,
# whose gradients nearly cancel, 0.1-0.36 from f32 on both routes).
F32_TOL = {"vector": 1.25, "leaf": 2.0, "floor": 5e-3}


def mm_cases(plan) -> list:
    """(name, x rows, book, adjoint, Ci, Co) of the mmdet3d backbone's convs
    no MinkUNet34 conv has: its k3 stem at one input channel, and the first
    decoder blocks' k3 convs after the lateral concat (384 -> 256 at L3,
    128 -> 96 at L0)."""
    lv = plan.levels
    return [(name, lv[i].valid, lv[i].nbr3, lv[i].nbr3.flip(1), ci, co)
            for name, i, ci, co in (("MM stem L0 k3 1->32", 0, 1, 32),
                                    ("MM dec0 L3 k3 384->256", 3, 384, 256),
                                    ("MM dec3 L0 k3 128->96", 0, 128, 96))]


class plain_convs:
    """Inside, the sparse convs' autograd Functions call the plain K1/K2
    (`ops.conv`) in place of the kernels, on the card. `round_operands`
    keeps the f32 route's bf16 rounding of x and W (the kernels' inputs);
    without it an f32 model stays f32 throughout."""

    def __init__(self, round_operands: bool = True):
        self.round_operands = round_operands

    def __enter__(self):
        import torch

        from gcdlss_tpu_torch.ops import conv as plain
        from gcdlss_tpu_torch.ops import fused_conv

        self.saved = (fused_conv.gather_gemm, fused_conv.gather_gemm_backward,
                      fused_conv._kernel_operands)
        fused_conv.gather_gemm = (lambda x, nbr, w, out_dtype=torch.float32:
                                  plain.gather_conv(x, nbr, w, out_dtype))
        fused_conv.gather_gemm_backward = (
            lambda x, g, adj, w, out_dtype=torch.float32, reverse=False, need_dx=True:
            plain.gather_conv_backward(x, g, adj.flip(1) if reverse else adj, w, out_dtype,
                                       need_dx))
        if not self.round_operands:
            fused_conv._kernel_operands = lambda x, w: (x, w.to(x.dtype), x.dtype)
        return self

    def __exit__(self, *exc):
        from gcdlss_tpu_torch.ops import fused_conv

        (fused_conv.gather_gemm, fused_conv.gather_gemm_backward,
         fused_conv._kernel_operands) = self.saved
        return False


def library_models() -> list:
    """(name, factory(dtype)) of every library model at its reference
    widths: the mmdet3d MultiHeadMinkUnet18 (base 32, encoder 32/64/128/256
    x 2, decoder 256/128/96/96 x 2, 3 heads, over-clustering 3) and the
    wrappers and ORCA models at their default planes, with the dtype the
    path runs them in: bf16 for those that take a `dtype` (the other
    factories ignore it and build f32 backbones, the convs' f32 route)."""
    import torch

    from gcdlss_tpu_torch.models import backbone_mm, orca, wrappers

    g = lambda i: torch.Generator().manual_seed(i)
    return [
        ("MultiHeadMinkUnet18", lambda dt: backbone_mm.MultiHeadMinkUnet18(
            17, 2, num_heads=3, overcluster_factor=3, dtype=dt, generator=g(0)),
         torch.bfloat16),
        ("MultiHeadMinkUnet", lambda dt: wrappers.MultiHeadMinkUnet(
            17, 2, num_heads=3, overcluster_factor=3, dtype=dt, generator=g(1)),
         torch.bfloat16),
        ("DualMinkUnet", lambda dt: wrappers.DualMinkUnet(17, 2, generator=g(2)),
         torch.float32),
        ("MinkUnet34ORCA", lambda dt: orca.MinkUnet34ORCA(17, dtype=dt, generator=g(3)),
         torch.bfloat16),
        ("MinkUnetToy18", lambda dt: orca.MinkUnetToy18(17, dtype=dt, generator=g(4)),
         torch.bfloat16),
        ("MultiHeadSelfSupMinkUnet", lambda dt: wrappers.MultiHeadSelfSupMinkUnet(
            simgcd=True, generator=g(5)), torch.float32),
        ("MultiHeadMinkUnetFineTune", lambda dt: wrappers.MultiHeadMinkUnetFineTune(
            17, 19, generator=g(6)), torch.float32),
    ]


def library_loss(out: dict, labels, lab_mask, valid0, rows):
    """`losses.cross_entropy` of the labeled head on the labeled rows, plus
    `losses_zoo.supcon_loss` over `rows`' normalised features (one view,
    their labels; each backbone's features, both of `DualMinkUnet`'s), plus
    `losses_zoo.distill_loss` from one head to another: the first two
    unlabeled heads where a model has them, else the labeled head to itself
    across its two crops of `rows`."""
    import torch

    from gcdlss_tpu_torch.losses import cross_entropy
    from gcdlss_tpu_torch.losses_zoo import distill_loss, supcon_loss

    logits = out["logits_lab"] if "logits_lab" in out else out["logits"]
    l_ce = cross_entropy(logits, torch.where(lab_mask, labels, -1), valid0)
    l_sc = 0.0
    for key in ("feats", "feats_a", "feats_b"):
        if key in out:
            f = out[key][rows].float()
            f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(min=1e-12)
            l_sc = l_sc + supcon_loss(f[:, None], labels=labels[rows])
    heads = out.get("logits_unlab")
    student, teacher = ((heads[0][rows], heads[1][rows]) if heads is not None and heads.dim() == 3
                        else (logits[rows], logits[rows]))
    l_d = distill_loss(student, teacher, 5, warmup_teacher_temp_epochs=10, nepochs=50)
    return l_ce + l_sc + l_d


def _rel(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


def library_phase(device, card: str):
    """The library models on the card, on one plan at the `bench.py` shapes
    (2 + 2 synthetic scans, cap0 = S2_CAP0, `default_caps`): K1/K2 at the
    mmdet3d backbone's new shapes (`mm_cases`) against their plain versions;
    then for each model of `library_models` a train-mode forward and
    backward of `library_loss` in its dtype with every kernel's count set
    to 0 just before it and read just after (step ms, peak GiB), and, in
    eval mode on the same weights in f32, the outputs and every gradient
    with the kernels against the same model on the plain versions on the
    card (`plain_convs`), in its dtype: outputs relative <= REF_TOL, as
    `reference_phase`; the gradient vector relative <= GRAD_TOL. The two
    differ by the order of f32 sums, which flips bf16 roundings of the
    activations (and of the operands on the f32 route), so the gradient is
    also held leaf by leaf against the f32 gradient (the plain route without
    any bf16 rounding): the kernels' distance from it, of the vector and of
    each leaf, within F32_TOL of the plain route's. A second kernels run
    gives the run-to-run spread. Returns (kernel rows, launches per model
    and in all)."""
    import torch

    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
    from gcdlss_tpu_torch.ops.plan import plan_capacity_overflow
    from gcdlss_tpu_torch.ops.plan_kernel import cube_candidates_map, cube_neighbor_map
    from gcdlss_tpu_torch.tools.stage2_split import synthetic_sides
    from gcdlss_tpu_torch.train.common import default_caps, plan_and_gather
    from gcdlss_tpu_torch.train.discover import DiscoverConfig, _combine_batches

    kernels = {"K1": gather_gemm, "K2": gather_gemm_backward, "K3": cube_neighbor_map,
               "K4": cube_candidates_map}
    caps = default_caps(S2_CAP0)
    sup, unsup = synthetic_sides(device)
    combine_cfg = DiscoverConfig(num_labeled_classes=17, num_unlabeled_classes=2,
                                 num_classes=19, unknown_label=17, voxel_caps=caps,
                                 sup_voxel_cap=CAP0, mix_voxel_caps=caps, num_sup_scans=BATCH,
                                 point_cap=POINTS_PER_SCAN)
    batch = _combine_batches(sup, unsup, combine_cfg)
    plan, feats0, _, labels = plan_and_gather(batch, caps)
    overflow = int(plan_capacity_overflow(plan))
    valid0 = plan.levels[0].valid
    lab_mask = valid0 & (plan.rep < CAP0)
    gen = torch.Generator(device=device).manual_seed(11)
    vrows = torch.nonzero(valid0).squeeze(1)
    rows = vrows[torch.randperm(vrows.shape[0], generator=gen, device=device)[:LIBRARY_ROWS]]
    log(f"library plan: caps {caps}, unique voxels {[int(lv.count) for lv in plan.levels]}, "
        f"plan overflow {overflow}")
    if overflow:
        raise AssertionError(f"library: the plan dropped {overflow} voxels")
    krows = gemm_phase(plan, device, "library", mm_cases(plan))

    launches = {}
    for name, make, dtype in library_models():
        model = make(dtype).to(device).train()
        # one untimed pass first: the first use of a model's shapes allocates
        library_loss(model(plan, feats0), labels, lab_mask, valid0, rows).backward()
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        # the path: the plan (the same books again), the forward, the backward
        plan = plan_and_gather(batch, caps)[0]
        loss = library_loss(model(plan, feats0), labels, lab_mask, valid0, rows)
        loss.backward()
        end.record()
        torch.cuda.synchronize()
        launches[name] = {k: fn.launches for k, fn in kernels.items()}
        ms, peak = start.elapsed_time(end), torch.cuda.max_memory_allocated() / 2 ** 30
        train_loss = loss.item()

        model.eval()
        truth = model
        if dtype != torch.float32:
            truth = make(torch.float32).to(device).eval()
            truth.load_state_dict(model.state_dict())
        dname = str(dtype).removeprefix("torch.")
        runs = {}
        for tag, m, route in (("kernels", model, contextlib.nullcontext()),
                              ("kernels again", model, contextlib.nullcontext()),
                              ("plain", model, plain_convs()),
                              ("f32", truth, plain_convs(round_operands=False))):
            m.zero_grad(set_to_none=True)
            with route:
                out = m(plan, feats0)
                loss = library_loss(out, labels, lab_mask, valid0, rows)
                loss.backward()
            # the heads the loss does not read have no gradient, in every run
            runs[tag] = ({k: v.detach() for k, v in out.items()}, loss.detach(),
                         {k: p.grad.detach().float().clone() for k, p in m.named_parameters()
                          if p.grad is not None})
        (out_k, loss_k, g_k), (_, _, g_k2), (out_p, loss_p, g_p), (_, _, g_t) = runs.values()
        rel = {k: _rel(out_k[k], v) for k, v in out_p.items()}
        rel["loss"] = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        flat = lambda g: torch.cat([v.reshape(-1) for v in g.values()])
        grad = {"kernels vs plain": _rel(flat(g_k), flat(g_p)),
                "kernels run to run": _rel(flat(g_k2), flat(g_k)),
                "kernels vs f32": _rel(flat(g_k), flat(g_t)),
                "plain vs f32": _rel(flat(g_p), flat(g_t))}
        # leaf by leaf: the kernels' distance from the f32 gradient over the
        # plain route's (`F32_TOL`)
        leaf = {k: (_rel(g_k[k], g_p[k]), _rel(g_k[k], v), _rel(g_p[k], v)) for k, v in g_t.items()}
        excess = {k: e_k - F32_TOL["leaf"] * e_p for k, (_, e_k, e_p) in leaf.items()}
        worst_kp = max(leaf, key=lambda k: leaf[k][0])
        worst_ex = max(excess, key=excess.get)
        fmt = lambda d: json.dumps({k: float(f"{v:.3e}") for k, v in d.items()})
        show = lambda k: f"{k} {'/'.join(f'{v:.3e}' for v in leaf[k])}"
        log(f"library {name}: train-mode loss {train_loss:.6f}, fwd + bwd {ms:.1f} ms, peak "
            f"{peak:.3f} GiB, launches {launches[name]} | eval mode, kernels vs plain on the "
            f"card, relative: outputs {fmt(rel)}; gradient in {dname} {fmt(grad)}; "
            f"leaves (kernels vs plain / kernels vs f32 / plain vs f32) worst kernels vs plain "
            f"{show(worst_kp)}, worst over {F32_TOL['leaf']}x the plain route's {show(worst_ex)} "
            f"(excess {excess[worst_ex]:.3e}); "
            f"{len(leaf)} leaves ({card})")
        if not np.isfinite(train_loss):
            raise AssertionError(f"library {name}: non-finite loss {train_loss}")
        if not all(np.isfinite(v) and v <= REF_TOL for v in rel.values()):
            raise AssertionError(f"library {name}: kernels vs plain relative errors {rel} "
                                 f"above {REF_TOL}")
        if not (np.isfinite(grad["kernels vs plain"])
                and grad["kernels vs plain"] <= GRAD_TOL[dname]):
            raise AssertionError(f"library {name}: gradient kernels vs plain "
                                 f"{grad['kernels vs plain']} above {GRAD_TOL[dname]}")
        if not grad["kernels vs f32"] <= F32_TOL["vector"] * grad["plain vs f32"]:
            raise AssertionError(f"library {name}: the kernels' gradient is farther from the "
                                 f"f32 one than the plain route's: {grad}")
        if not excess[worst_ex] <= F32_TOL["floor"]:
            raise AssertionError(f"library {name}: the kernels' gradient of {worst_ex} is "
                                 f"farther from the f32 one than the plain route's: "
                                 f"{show(worst_ex)}")
        if not all(launches[name][k] > 0 for k in ("K1", "K2", "K3")):
            raise AssertionError(f"library {name}: a kernel was not launched: {launches[name]}")
        del model, truth, m, runs, out, loss, g_k, g_k2, g_p, g_t
    launches["total"] = {k: sum(run[k] for run in launches.values()) for k in kernels}
    return krows, launches


# ---- data parallelism over a process group (dp_phase)


def kernel_counters() -> dict:
    """K1-K4's wrappers, whose `launches` each path resets and reads."""
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward
    from gcdlss_tpu_torch.ops.plan_kernel import cube_candidates_map, cube_neighbor_map

    return {"K1": gather_gemm, "K2": gather_gemm_backward, "K3": cube_neighbor_map,
            "K4": cube_candidates_map}


DP_WORLD = 2
DP_CASES = (("stage1", "kernels"), ("stage2", "kernels"), ("stage1", "plain_f32"),
            ("stage2", "plain_f32"))
DP_COUNTS = ("n_cand", "n_rel", "has_novel", "cand_overflow", "plan_overflow")
# kernels route (`dp_phase`): relative, of the total loss, of each term, of
# n_cand, of n_rel and the queue's counts, of the state
DP_BF16_TOL = {"loss": 1e-3, "terms": 0.15, "n_cand": 1e-3, "counts": 5e-2, "state": 1e-2}


def dp_config(stage: str, route: str):
    """The `bench.py` Stage-1 (2 scans) or Stage-2 (2 + 2 scans) config;
    bf16 on the kernels, f32 on the plain route."""
    from gcdlss_tpu_torch.train.common import default_caps
    from gcdlss_tpu_torch.train.discover import DiscoverConfig
    from gcdlss_tpu_torch.train.pretrain import PretrainConfig

    dtype = "bfloat16" if route == "kernels" else "float32"
    if stage == "stage1":
        return PretrainConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                              voxel_caps=default_caps(CAP0), dtype=dtype)
    caps = default_caps(S2_CAP0)
    return DiscoverConfig(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                          unknown_label=17, voxel_caps=caps, sup_voxel_cap=CAP0,
                          mix_voxel_caps=caps, num_sup_scans=BATCH, point_cap=POINTS_PER_SCAN,
                          voxel_size=VOXEL_SIZE, dtype=dtype, cand_cap=4096, queue_slots=20,
                          queue_per_slot=1024, kmeans_iters=15, steps_per_epoch=1000)


def dp_run(device, stage: str, route: str, group=None, rank: int = 0, world: int = 1) -> dict:
    """One step of `stage` from the state of seed 0 on the synthetic sides
    (`tools.stage2_split.synthetic_sides`): the one-process step on all
    scans (`group` None) or this rank's share of the group's (its scans,
    `parallel.mesh.shard_voxel_batch`; the state broadcast from rank 0).
    Returns the metrics, the state (on the CPU), the step's device ms, the
    process's peak memory over the step and that peak less what the process
    held when the step began (the step's own)."""
    import torch

    from gcdlss_tpu_torch.parallel import mesh
    from gcdlss_tpu_torch.tools.stage2_split import synthetic_sides
    from gcdlss_tpu_torch.train.discover import create_discover_state, discover_train_step
    from gcdlss_tpu_torch.train.pretrain import create_pretrain_state, pretrain_train_step

    cfg = dp_config(stage, route)
    sup, unsup = synthetic_sides(device)
    if group is not None:
        sup = mesh.shard_voxel_batch(sup, BATCH, rank, world)
        unsup = mesh.shard_voxel_batch(unsup, BATCH, rank, world)
    if stage == "stage1":
        state = create_pretrain_state(0, cfg, device)
        models = {"model": state.model}
        if group is not None:
            mesh.replicate(state.model, group=group)
        step = lambda: pretrain_train_step(state, sup, cfg, group=group)[1]
    else:
        state = create_discover_state(0, cfg, device=device)
        models = {"student": state.student, "teacher": state.teacher}
        if group is not None:
            mesh.replicate(state.student, state.teacher, state.tau, state.generator,
                           state.queue, group=group)
        step = lambda: discover_train_step(state, sup, unsup, cfg, group=group)[1]
    with (plain_convs(round_operands=False) if route == "plain_f32"
          else contextlib.nullcontext()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step()
        end.record()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = {"ms": start.elapsed_time(end), "peak_gib": peak / 2 ** 30,
           "step_gib": (peak - held) / 2 ** 30,
           "metrics": {k: v.detach().cpu() for k, v in metrics.items()},
           "valid": [int(sup["valid"].sum())] + ([] if stage == "stage1"
                                                   else [int(unsup["valid"].sum())])}
    for who, m in models.items():
        out[who] = {k: v.detach().cpu() for k, v in m.state_dict().items()}
    if stage == "stage2":
        out["queue"] = tuple(a.detach().cpu() for a in state.queue)
    return out


def dp_worker(rank: int, world: int, tmp: str) -> None:
    """A rank of `dp_phase`'s two-process run: gloo over CUDA tensors, both
    ranks on card 0, a `FileStore` in `tmp`. Runs every case of DP_CASES and
    saves its results and its kernel launches to `tmp/rank{rank}.pt`."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    kernels = kernel_counters()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_b", rank=rank,
                            world_size=world)
    try:
        res, launches = {}, {k: 0 for k in kernels}
        for stage, route in DP_CASES:
            for fn in kernels.values():
                fn.launches = 0
            res[(stage, route)] = dp_run(device, stage, route, dist.group.WORLD, rank, world)
            if route == "kernels":
                for k, fn in kernels.items():
                    launches[k] += fn.launches
        torch.save({"results": res, "launches": launches}, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _state_diff(a: dict, b: dict) -> tuple:
    """(largest |a - b| / max(max|b|, 1e-3) over the tensors, its name), and
    whether a and b are the same bits."""
    worst, where, same = 0.0, None, True
    for who in ("model", "student", "teacher"):
        for k, v in b.get(who, {}).items():
            got = a[who][k]
            same = same and torch_equal(got, v)
            if v.is_floating_point():
                d = float((got.float() - v.float()).abs().max()) / max(
                    float(v.float().abs().max()), 1e-3)
                if d > worst:
                    worst, where = d, f"{who} {k}"
    for x, y in zip(a.get("queue", ()), b.get("queue", ())):
        same = same and torch_equal(x, y)
    for k, v in b["metrics"].items():
        same = same and torch_equal(a["metrics"][k], v)
    return worst, where, same


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def dp_phase(device, card: str) -> dict:
    """Data parallelism on the card. (a) One rank over NCCL in this process
    (`init_process_group` with a `FileStore` in a temporary directory): the
    Stage-1 and Stage-2 steps at the `bench.py` shapes (bf16, kernels) with
    the group give the bits of the same steps without it: parameters,
    statistics, metrics and queue. (b) Two processes on the one card over
    gloo with CUDA tensors (`dp_worker`), each holding 1 + 1 scans, against
    the one-process 2 + 2 step in this process: every rank ends with the
    same bits; plan overflow 0 on both; on the plain f32 route (no bf16
    operand rounding: the steps differ only in the order of f32 sums, as on
    the CPU) the counts and queue counts equal and losses, tau, parameters,
    statistics and queue within `tests/test_torch_dp.py`'s tolerances; on
    the kernels (bf16) a change of summation order moves bf16-rounded
    activations by ~1e-3 relative (`reference_phase`), which moves a few
    candidates across the threshold: there the losses, `n_cand`, `n_rel`,
    the queue's counts and the state are held within DP_BF16_TOL. Step ms of
    every run. Returns the kernels' launches in (a)'s group runs and (b)'s
    kernel route."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    kernels = kernel_counters()
    launches = {k: 0 for k in kernels}
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        # (a) one rank over NCCL
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store_a", rank=0,
                                world_size=1)
        try:
            for stage in ("stage1", "stage2"):
                ref = dp_run(device, stage, "kernels")
                again = dp_run(device, stage, "kernels")
                for fn in kernels.values():
                    fn.launches = 0
                got = dp_run(device, stage, "kernels", dist.group.WORLD, 0, 1)
                for k, fn in kernels.items():
                    launches[k] += fn.launches
                repeat = _state_diff(again, ref)[2]
                worst, where, same = _state_diff(got, ref)
                log(f"dp (a) {stage}: one NCCL rank vs no group: "
                    f"{'the same bits' if same else f'differs, worst {worst:.3e} at {where}'}; "
                    f"no group twice: {'the same bits' if repeat else 'differs'} | step "
                    f"{got['ms']:.1f} ms with the group, {ref['ms']:.1f} ms without ({card})")
                if not same:
                    raise AssertionError(f"dp (a) {stage}: the one-rank group step is not the "
                                         f"step without a group (worst {worst} at {where})")
        finally:
            dist.destroy_process_group()

        # (b) two processes on the one card, gloo over CUDA tensors
        single = {case: dp_run(device, *case) for case in DP_CASES}
        torch.cuda.empty_cache()
        mp.start_processes(dp_worker, args=(DP_WORLD, tmp), nprocs=DP_WORLD,
                           start_method="spawn", join=True)
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(DP_WORLD)]
    for r in ranks:
        for k in kernels:
            launches[k] += r["launches"][k]
    for case in DP_CASES:
        stage, route = case
        one, grp = single[case], [r["results"][case] for r in ranks]
        worst, where, same = _state_diff(grp[1], grp[0])
        if not same:
            raise AssertionError(f"dp (b) {case}: the ranks end with different states "
                                 f"(worst {worst} at {where})")
        worst, where, _ = _state_diff(grp[0], one)
        m1, mg = one["metrics"], grp[0]["metrics"]
        counts = {k: (int(m1[k]), int(mg[k])) for k in DP_COUNTS if k in m1}
        losses = {k: (float(m1[k]), float(mg[k])) for k, v in m1.items()
                  if v.is_floating_point()}
        loss_rel = {k: abs(b - a) / max(abs(a), 1e-12) for k, (a, b) in losses.items()}
        queue = ""
        if stage == "stage2":
            qd = float((grp[0]["queue"][0] - one["queue"][0]).abs().max()) / max(
                float(one["queue"][0].abs().max()), 1e-3)
            qc = torch_equal(grp[0]["queue"][1], one["queue"][1]) and torch_equal(
                grp[0]["queue"][2], one["queue"][2])
            queue = f"; queue feats {qd:.3e}, counts and head {'equal' if qc else 'differ'}"
        log(f"dp (b) {stage} {route}: 2 ranks x {grp[0]['valid']} / {grp[1]['valid']} voxels vs "
            f"one process {one['valid']}: counts (one, group) {counts}; losses relative "
            f"{json.dumps({k: float(f'{v:.3e}') for k, v in loss_rel.items()})}; state worst "
            f"{worst:.3e} at {where}{queue} | step {grp[0]['ms']:.1f} / {grp[1]['ms']:.1f} ms "
            f"a rank, {one['ms']:.1f} ms one process ({card})")
        if counts["plan_overflow"] != (0, 0):
            raise AssertionError(f"dp (b) {case}: a plan dropped voxels {counts}")
        if route == "plain_f32":
            bad = [k for k, (a, b) in counts.items() if a != b]
            bad += [k for k, (a, b) in losses.items()
                    if not abs(b - a) <= 1e-5 * abs(a) + 1e-6]
            if worst > 1e-4:
                bad.append(f"state {where}")
            if stage == "stage2" and not (qd <= 1e-4 and qc):
                bad.append("queue")
            if bad:
                raise AssertionError(f"dp (b) {case}: the group step differs from the "
                                     f"one-process step in {bad}")
        else:
            # bf16: bounds ~10x what the first run measured (total loss
            # 1.2e-4, the terms up to 1.4e-2, n_cand 4e-5, n_rel 5.1e-3,
            # state 7.2e-4 relative); a missing reduction moves them by tens
            # of percent
            bad = [k for k, (a, b) in losses.items() if not np.isfinite(b)]
            bad += [k for k, v in loss_rel.items()
                    if not v <= DP_BF16_TOL["loss" if k == "loss" else "terms"]]
            near = lambda a, b, tol: abs(b - a) <= tol * abs(a)
            if stage == "stage2":
                if not near(*counts["n_cand"], DP_BF16_TOL["n_cand"]):
                    bad.append("n_cand")
                if not near(*counts["n_rel"], DP_BF16_TOL["counts"]):
                    bad.append("n_rel")
                if not (near(float(one["queue"][1].sum()), float(grp[0]["queue"][1].sum()),
                             DP_BF16_TOL["counts"])
                        and torch_equal(grp[0]["queue"][2], one["queue"][2])):
                    bad.append("queue counts")
            if not worst <= DP_BF16_TOL["state"]:
                bad.append(f"state {where}")
            if bad:
                raise AssertionError(f"dp (b) {case}: the group step is off the one-process "
                                     f"step in {bad}")
    if not all(launches[k] > 0 for k in ("K1", "K2", "K3")):
        raise AssertionError(f"dp: a kernel was not launched: {launches}")
    return launches


# ---- voxel sharding over a process group (sp_phase)

SP_WORLD = 2
# dp x sp: two batch groups (one scan each, caps `default_caps(CAP0 // 2)`)
# of two-rank rings
DPSP_DP, DPSP_SP = 2, 2
DPSP_CASES = (("stage1", "kernels"), ("stage1", "plain_f32"))
# the sharded convs held against their plain versions on the card, on rank
# 0's window books of the Stage-2 plan: (name, kind, level, Ci, Co)
SP_CONV_CASES = (("L1 k3 32->32", "subm", 1, 32, 32), ("down L1->L2 32->32", "down", 1, 32, 32),
                 ("up L2->L1 128->96", "up", 1, 128, 96))
# kernels route (`sp_phase`): relative, of the total loss, of each term, of
# n_cand, of n_rel and the queue's counts, of the state; ~10x what the
# first run measured (total loss 2.1e-5, the terms up to 1.0e-3, n_cand
# 3.8e-5, n_rel 3.4e-3, state 7.2e-4 relative; NVIDIA H100 80GB HBM3,
# 700 W); a missing reduction or a dropped halo row moves them by tens of
# percent. The queue's features are held on the plain f32 route alone:
# here the two runs mine other candidates (n_rel differs), so the queues
# hold other rows and only their summed counts and head compare
SP_BF16_TOL = {"loss": 2e-4, "terms": 1e-2, "n_cand": 4e-4, "counts": 3e-2, "state": 1e-2}


def dpsp_config(route: str):
    """A dp x sp batch group's Stage-1 config: one scan, `default_caps(CAP0 // 2)`."""
    import dataclasses

    from gcdlss_tpu_torch.train.common import default_caps

    return dataclasses.replace(dp_config("stage1", route), voxel_caps=default_caps(CAP0 // 2))


def sp_halos(device) -> dict:
    """The halos every sharded run takes, sized here from this run's plans
    (`parallel.sp_step.backbone_halos`): Stage 1's at sp 2, Stage 2's
    combined plan's and, per route, its LaserMix plan's (`probe_mix_plan`,
    the first step's draws), and the dp x sp groups' (the larger of the two
    groups' plans, each at sp 2)."""
    from gcdlss_tpu_torch.parallel import mesh
    from gcdlss_tpu_torch.parallel.sp_discover import probe_mix_plan
    from gcdlss_tpu_torch.parallel.sp_step import backbone_halos
    from gcdlss_tpu_torch.tools.stage2_split import synthetic_sides
    from gcdlss_tpu_torch.train.common import plan_and_gather
    from gcdlss_tpu_torch.train.discover import _combine_batches, create_discover_state

    sup, unsup = synthetic_sides(device)
    out = {"stage1": backbone_halos(plan_and_gather(sup, dp_config("stage1", "kernels")
                                                    .voxel_caps)[0], SP_WORLD)}
    caps = dpsp_config("kernels").voxel_caps
    groups = [backbone_halos(plan_and_gather(mesh.shard_voxel_batch(sup, BATCH, g, DPSP_DP),
                                             caps)[0], DPSP_SP) for g in range(DPSP_DP)]
    out["dpsp"] = tuple(max(h) for h in zip(*groups))
    for route in ("kernels", "plain_f32"):
        cfg = dp_config("stage2", route)
        plan = plan_and_gather(_combine_batches(sup, unsup, cfg), cfg.voxel_caps)[0]
        with (plain_convs(round_operands=False) if route == "plain_f32"
              else contextlib.nullcontext()):
            mix = probe_mix_plan(cfg, create_discover_state(0, cfg, device=device), sup, unsup)
        out[("stage2", route)] = (backbone_halos(plan, SP_WORLD), backbone_halos(mix, SP_WORLD))
    return out


def sp_run(device, stage: str, route: str, halos, dpsp: bool = False, rank: int = 0) -> dict:
    """One sharded step of `stage` from the state of seed 0 on the synthetic
    sides, this rank's part (`make_sp_pretrain_step` /
    `make_sp_discover_step` over the world; with `dpsp`,
    `make_dp_sp_pretrain_step` on group rank // DPSP_SP's scan). Returns
    what `dp_run` returns (ms and memory of the first step), the metrics
    the step's, the kernels' launch counts read after it and, on the
    kernels, the ms of a second step."""
    import torch

    from gcdlss_tpu_torch.parallel import mesh
    from gcdlss_tpu_torch.parallel import sp_discover, sp_step
    from gcdlss_tpu_torch.tools.stage2_split import synthetic_sides
    from gcdlss_tpu_torch.train.discover import create_discover_state
    from gcdlss_tpu_torch.train.pretrain import create_pretrain_state

    cfg = dpsp_config(route) if dpsp else dp_config(stage, route)
    sup, unsup = synthetic_sides(device)
    if stage == "stage1":
        state = create_pretrain_state(0, cfg, device)
        models = {"model": state.model}
        if dpsp:
            batch = mesh.shard_voxel_batch(sup, BATCH, rank // DPSP_SP, DPSP_DP)
            fn = sp_step.make_dp_sp_pretrain_step(cfg, halos, DPSP_SP, device)
        else:
            batch = sup
            fn = sp_step.make_sp_pretrain_step(cfg, None, halos, device)
        step = lambda: fn(state, batch)[1]
    else:
        state = create_discover_state(0, cfg, device=device)
        models = {"student": state.student, "teacher": state.teacher}
        fn = sp_discover.make_sp_discover_step(cfg, None, *halos, device)
        step = lambda: fn(state, sup, unsup)[1]
    with (plain_convs(round_operands=False) if route == "plain_f32"
          else contextlib.nullcontext()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step()
        end.record()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = {"ms": start.elapsed_time(end), "peak_gib": peak / 2 ** 30,
           "step_gib": (peak - held) / 2 ** 30,
           "metrics": {k: v.detach().cpu() for k, v in metrics.items()},
           "launches": {k: fn.launches for k, fn in kernel_counters().items()}}
    for who, m in models.items():
        out[who] = {k: v.detach().cpu() for k, v in m.state_dict().items()}
    if stage == "stage2":
        out["queue"] = tuple(a.detach().cpu() for a in state.queue)
    if route == "kernels":
        # a second step: the first one pays the process's first use of the
        # card and of the group
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        out["warm_ms"] = start.elapsed_time(end)
    return out


def window_rows(caps: tuple, halos: tuple, world: int) -> list:
    """Rows of each level's k3 window (block + 2 x padded halo) on a rank
    of a ring of `world` (the same on every rank)."""
    from gcdlss_tpu_torch.parallel.voxel_shard import padded_halo

    return [c // world + 2 * padded_halo(halos[1 + l], c // world) for l, c in enumerate(caps)]


def _window_valid(valid, ln: int, halo: int, rank: int):
    """The level's validity at a rank's window rows (the wrapped halos not valid)."""
    import torch

    g = torch.arange(ln + 2 * halo, device=valid.device) + rank * ln - halo
    ok = (g >= 0) & (g < valid.shape[0])
    return valid[g.clamp(0, valid.shape[0] - 1)] & ok


def sp_conv_checks(device, halos, rank: int) -> tuple:
    """The sharded subm, down and up convs (`parallel.voxel_shard`) on the
    Stage-2 plan's window books at SP_CONV_CASES: whole (exchange, K1, K2,
    fold) against the same under `plain_convs` (the bf16-rounded operands,
    f32 sums), outputs and the input's and W's gradients; and on rank 0 K1
    and K2 alone on the window books against their plain versions
    (`gemm_phase`: kernel rows). Returns (the rows, the worst relative
    error of the whole convs)."""
    import torch
    import torch.distributed as dist

    from gcdlss_tpu_torch.parallel import voxel_shard as vs
    from gcdlss_tpu_torch.parallel.sp_step import shard_plan
    from gcdlss_tpu_torch.tools.stage2_split import synthetic_sides
    from gcdlss_tpu_torch.train.common import plan_and_gather
    from gcdlss_tpu_torch.train.discover import _combine_batches

    cfg = dp_config("stage2", "kernels")
    sup, unsup = synthetic_sides(device)
    plan = plan_and_gather(_combine_batches(sup, unsup, cfg), cfg.voxel_caps)[0]
    group = dist.group.WORLD
    sp = shard_plan(plan, group, halos)
    worst, cases = 0.0, []
    for name, kind, lvl, ci, co in SP_CONV_CASES:
        fine, coarse = plan.levels[lvl].valid, plan.levels[lvl + 1].valid
        book, pool = sp.levels[lvl].nbr3, sp.pools[lvl]
        if kind == "subm":
            full, ln, halo = fine, fine.shape[0] // SP_WORLD, book.halo
            cases.append((f"sp window {name}", _window_valid(fine, ln, halo, rank), book.nbr,
                          book.adj, ci, co))
            conv = lambda x, w: vs.sp_gather_conv(x, book, w)[0]
        elif kind == "down":
            full = fine
            cases.append((f"sp window {name}", sp.levels[lvl].valid, pool.children, pool.upmap,
                          ci, co))
            conv = lambda x, w: vs.sp_down_conv(x, pool, w)[0]
        else:
            full = coarse
            cases.append((f"sp window {name}", _window_valid(coarse, pool.lc, pool.halo, rank),
                          pool.upmap, pool.children, ci, co))
            conv = lambda x, w: vs.sp_up_conv(x, pool, w)[0]
        ln = full.shape[0] // SP_WORLD
        gen = torch.Generator(device=device).manual_seed(11)
        x_all = torch.randn(full.shape[0], ci, device=device, generator=gen) * full[:, None]
        w = torch.randn(8 if kind != "subm" else 27, ci, co, device=device, generator=gen) * 0.1
        got = []
        for plain in (False, True):
            xl = x_all[rank * ln:(rank + 1) * ln].to(torch.bfloat16).requires_grad_()
            wl = w.to(torch.bfloat16).requires_grad_()
            with plain_convs() if plain else contextlib.nullcontext():
                out = conv(xl, wl)
                gen_c = torch.Generator(device=device).manual_seed(12 + rank)
                out.float().backward(torch.randn(out.shape, device=device, generator=gen_c))
            got.append((out.detach().float(), xl.grad.float(), wl.grad.float()))
        for a, b in zip(*got):
            worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6))
    torch.cuda.synchronize()
    rows = gemm_phase(None, device, "stage2", cases) if rank == 0 else []
    return rows, worst


def sp_worker(rank: int, world: int, tmp: str, halos: dict, measured: dict) -> None:
    """A rank of `sp_phase`'s runs: gloo over CUDA tensors, every rank on
    card 0, a `FileStore` in `tmp`. World SP_WORLD: every case of DP_CASES
    sharded over the two ranks, then `sp_conv_checks`; world DPSP_DP x
    DPSP_SP: DPSP_CASES on the dp x sp mesh. Saves the results, each kernels
    case's launches and the conv rows to `tmp/{sp|dpsp}{rank}.pt`."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    MEASURED.update(measured)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    dpsp = world != SP_WORLD
    tag = "dpsp" if dpsp else "sp"
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{tag}", rank=rank,
                            world_size=world)
    kernels = kernel_counters()
    try:
        res, launches = {}, {}
        for stage, route in (DPSP_CASES if dpsp else DP_CASES):
            h = halos["dpsp"] if dpsp else halos[stage] if stage == "stage1" else halos[
                (stage, route)]
            for fn in kernels.values():
                fn.launches = 0
            res[(stage, route)] = sp_run(device, stage, route, h, dpsp, rank)
            if route == "kernels":  # the first step's
                launches[stage] = res[(stage, route)]["launches"]
        rows, conv_err = ([], None) if dpsp else sp_conv_checks(
            device, halos[("stage2", "kernels")][0], rank)
        torch.save({"results": res, "launches": launches, "rows": rows, "conv_err": conv_err},
                   f"{tmp}/{tag}{rank}.pt")
    finally:
        dist.destroy_process_group()


def _sp_check(name: str, one: dict, grp: list, route: str, stage: str, card: str) -> None:
    """Hold a sharded case's ranks to each other (the same bits) and to the
    one-process step (`one`); print its line. Raises on a miss."""
    worst, where, same = _state_diff(grp[1], grp[0])
    for other in grp[2:]:
        same = same and _state_diff(other, grp[0])[2]
    if not same:
        raise AssertionError(f"sp {name}: the ranks end with different states "
                             f"(worst {worst} at {where})")
    worst, where, _ = _state_diff(grp[0], one)
    m1, mg = one["metrics"], grp[0]["metrics"]
    counts = {k: (int(m1[k]), int(mg[k])) for k in DP_COUNTS if k in m1}
    losses = {k: (float(m1[k]), float(mg[k])) for k, v in m1.items() if v.is_floating_point()}
    loss_rel = {k: abs(b - a) / max(abs(a), 1e-12) for k, (a, b) in losses.items()}
    qd, qc = 0.0, True
    if stage == "stage2":
        qd = float((grp[0]["queue"][0] - one["queue"][0]).abs().max()) / max(
            float(one["queue"][0].abs().max()), 1e-3)
        qc = torch_equal(grp[0]["queue"][1], one["queue"][1]) and torch_equal(
            grp[0]["queue"][2], one["queue"][2])
    log(f"sp {name}: sp_overflow {int(mg['sp_overflow'])}, counts (one, sharded) {counts}; "
        f"losses relative {json.dumps({k: float(f'{v:.3e}') for k, v in loss_rel.items()})}; "
        f"state worst {worst:.3e} at {where}"
        + (f"; queue feats {qd:.3e}, counts and head {'equal' if qc else 'differ'}"
           if stage == "stage2" else "")
        + f" | step {' / '.join(f'{r['ms']:.1f}' for r in grp)} ms a rank"
        + (f" (the second {' / '.join(f'{r['warm_ms']:.1f}' for r in grp)})"
           if "warm_ms" in grp[0] else "")
        + f", {one['ms']:.1f} ms one process"
        + (f" (again {one['warm_ms']:.1f})" if "warm_ms" in one else "")
        + f"; peak {' / '.join(f'{r['peak_gib']:.3f}' for r in grp)} GiB a rank, the step's own "
        f"{' / '.join(f'{r['step_gib']:.3f}' for r in grp)}; one process {one['step_gib']:.3f} "
        f"GiB the step's own ({card})")
    if int(mg["sp_overflow"]) != 0 or counts["plan_overflow"] != (0, 0):
        raise AssertionError(f"sp {name}: overflow, sp {int(mg['sp_overflow'])}, "
                             f"plan {counts['plan_overflow']}")
    if route == "plain_f32":
        bad = [k for k, (a, b) in counts.items() if a != b]
        bad += [k for k, (a, b) in losses.items() if not abs(b - a) <= 1e-5 * abs(a) + 1e-6]
        if worst > 1e-4:
            bad.append(f"state {where}")
        if stage == "stage2" and not (qd <= 1e-4 and qc):
            bad.append("queue")
    else:
        bad = [k for k, (a, b) in losses.items() if not np.isfinite(b)]
        bad += [k for k, v in loss_rel.items()
                if not v <= SP_BF16_TOL["loss" if k == "loss" else "terms"]]
        near = lambda a, b, tol: abs(b - a) <= tol * abs(a)
        if stage == "stage2":
            if not near(*counts["n_cand"], SP_BF16_TOL["n_cand"]):
                bad.append("n_cand")
            if not near(*counts["n_rel"], SP_BF16_TOL["counts"]):
                bad.append("n_rel")
            if not (near(float(one["queue"][1].sum()), float(grp[0]["queue"][1].sum()),
                         SP_BF16_TOL["counts"]) and torch_equal(grp[0]["queue"][2],
                                                                one["queue"][2])):
                bad.append("queue counts")
        if not worst <= SP_BF16_TOL["state"]:
            bad.append(f"state {where}")
    if bad:
        raise AssertionError(f"sp {name}: the sharded step is off the one-process step in {bad}")


def sp_phase(device, card: str):
    """Voxel sharding on the card, at the `bench.py` shapes (MinkUNet34,
    80k-point scans at 0.05 m, `default_caps`). (a) Two processes on the one
    card over gloo with CUDA tensors (`sp_worker`), each holding the whole
    batch and half of every level's rows: Stage 1 (2 scans, cap0 138,240)
    and Stage 2 (2 + 2 scans, cap0 276,480), on the kernels (bf16) and on a
    plain f32 route, against the one-process step in this process; then the
    sharded subm, down and up convs on one Stage-2 level each against their
    plain versions (`sp_conv_checks`). (b) Four processes, dp 2 x sp 2,
    Stage 1 (one scan a batch group) against the one-process step on the
    union batch. Prints the halos, the window rows, the overflows, the
    worst state difference, the step ms and peak memory per rank (beside
    the one-process step's) and each rank's K1/K2/K3 launches; fails on
    any overflow, ranks that differ in any bit, the plain route off the CPU
    tests' tolerances, the kernels off SP_BF16_TOL, a sharded conv off
    OUT_TOL, or a kernel a sharded rank did not launch.
    Returns (the conv rows, the sharded ranks' launches)."""
    import torch
    import torch.multiprocessing as mp

    halos = sp_halos(device)
    s1, s2 = dp_config("stage1", "kernels").voxel_caps, dp_config("stage2", "kernels").voxel_caps
    log(f"sp halos (stem, subm0..4, pool0..3): stage 1 {halos['stage1']}; stage 2 "
        + "; ".join(f"{r} {halos[('stage2', r)][0]}, mix {halos[('stage2', r)][1]}"
                    for r in ("kernels", "plain_f32"))
        + f"; dp x sp {halos['dpsp']} | k3 window rows a level (blocks of "
        f"{[c // SP_WORLD for c in s1]} / {[c // SP_WORLD for c in s2]}): stage 1 "
        f"{window_rows(s1, halos['stage1'], SP_WORLD)}, stage 2 "
        f"{window_rows(s2, halos[('stage2', 'kernels')][0], SP_WORLD)}, mix "
        f"{window_rows(s2, halos[('stage2', 'kernels')][1], SP_WORLD)}, dp x sp "
        f"{window_rows(dpsp_config('kernels').voxel_caps, halos['dpsp'], DPSP_SP)}")
    single = {case: dp_run(device, *case) for case in DP_CASES}
    for case in DP_CASES:  # a second one-process step, as the ranks take one
        if case[1] == "kernels":
            single[case]["warm_ms"] = dp_run(device, *case)["ms"]
    torch.cuda.empty_cache()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        mp.start_processes(sp_worker, args=(SP_WORLD, tmp, halos, dict(MEASURED)),
                           nprocs=SP_WORLD, start_method="spawn", join=True)
        ranks = [torch.load(f"{tmp}/sp{r}.pt") for r in range(SP_WORLD)]
        torch.cuda.empty_cache()
        mp.start_processes(sp_worker, args=(DPSP_DP * DPSP_SP, tmp, halos, dict(MEASURED)),
                           nprocs=DPSP_DP * DPSP_SP, start_method="spawn", join=True)
        dpsp = [torch.load(f"{tmp}/dpsp{r}.pt") for r in range(DPSP_DP * DPSP_SP)]
    launches = {k: 0 for k in ("K1", "K2", "K3", "K4")}
    for tag, group in (("(a)", ranks), ("(b) dp 2 x sp 2", dpsp)):
        for r, res in enumerate(group):
            for stage, counts in res["launches"].items():
                log(f"sp {tag} rank {r} {stage} kernels launches {counts}")
                for k, n in counts.items():
                    launches[k] += n
                if not all(counts[k] > 0 for k in ("K1", "K2", "K3")):
                    raise AssertionError(f"sp {tag} rank {r} {stage}: a kernel was not "
                                         f"launched: {counts}")
    for case in DP_CASES:
        _sp_check(f"(a) {case[0]} {case[1]}", single[case],
                  [r["results"][case] for r in ranks], case[1], case[0], card)
    for case in DPSP_CASES:
        _sp_check(f"(b) dp 2 x sp 2 {case[0]} {case[1]}", single[case],
                  [r["results"][case] for r in dpsp], case[1], case[0], card)
    conv_err = max(r["conv_err"] for r in ranks)
    log(f"sp convs on the window books ({', '.join(c[0] for c in SP_CONV_CASES)}): sharded "
        f"kernels vs plain, worst relative {conv_err:.3e} (outputs, dX, dW)")
    if not conv_err <= OUT_TOL:
        raise AssertionError(f"sp convs: kernels off the plain versions by {conv_err}")
    return ranks[0]["rows"], launches


ALONE = {"library": library_phase, "dp": dp_phase, "sp": sp_phase}  # `--only NAME`


def main() -> int:
    import torch

    only = sys.argv[2:] if sys.argv[1:2] == ["--only"] else []
    if sys.argv[1:] and not (only and set(only) <= set(ALONE)):
        print(f"usage: chip_smoke.py [--only {'|'.join(ALONE)} ...]", file=sys.stderr)
        return 2
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
    if only:
        for name in only:
            log(f"{name}: {phase(name, ALONE[name], device, card)}")
        return 0
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
    cyl_rows, launches_cyl = phase("cylinder", cylinder_phase, device, card)
    launches_cli = phase("cli", cli_phase, device, card)
    launches_dq = phase("discovery quality", discovery_phase, device, card)
    lib_rows, launches_lib = phase("library", library_phase, device, card)
    launches_dp = phase("dp", dp_phase, device, card)
    sp_rows, launches_sp = phase("sp", sp_phase, device, card)
    log(f"phases (wall s): {json.dumps({k: round(v, 1) for k, v in wall.items()})}; "
        f"remat peaks (GiB) {peaks_remat}")
    # `launches`: K1-K4 on the Stage-2 path (the training path that runs all
    # four; `launches_stage1` the Stage-1 path, `launches_stage15` the
    # Stage-1.5 phase, `launches_variants` the Stage-2 variants together,
    # `launches_nops` the four single-model recipes together, `launches_cli`
    # the CLI's eighteen runs together, `launches_quality` the discovery-quality
    # run, `launches_cylinder` the Cylinder3D Stage-2 and trainer paths
    # together, `launches_library` the seven library models' steps together,
    # `launches_dp` the data-parallel group runs: (a)'s and both ranks' of
    # (b) on the kernels, `launches_sp` the voxel-sharded runs' ranks on the
    # kernels: (a)'s two and (b)'s four), P1-P4 in
    # the tool's main run (their only path; K1's launches there are
    # `launches_parts`)
    rows += cyl_rows + lib_rows + sp_rows
    for r in rows:
        r["launches"] = launches_s2[r["name"][:2]]
        r["launches_stage1"] = launches_s1[r["name"][:2]]
        r["launches_stage15"] = launches_s15["total"][r["name"][:2]]
        r["launches_variants"] = launches_var["total"][r["name"][:2]]
        r["launches_nops"] = launches_nops["total"][r["name"][:2]]
        r["launches_quality"] = launches_dq[r["name"][:2]]
        r["launches_cylinder"] = launches_cyl["total"][r["name"][:2]]
        if r["name"][:2] == "K1":
            r["launches_parts"] = launches_parts["K1"]
    for r in part_rows:
        r["launches"] = launches_parts[r["name"][:2]]
    rows += part_rows
    for r in rows:
        r["launches_cli"] = launches_cli["total"][r["name"][:2]]
        r["launches_library"] = launches_lib["total"].get(r["name"][:2], 0)
        r["launches_dp"] = launches_dp.get(r["name"][:2], 0)
        r["launches_sp"] = launches_sp.get(r["name"][:2], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    extra = ("launches_stage1", "launches_stage15", "launches_variants", "launches_nops",
             "launches_cli", "launches_quality", "launches_cylinder", "launches_library",
             "launches_dp", "launches_sp", "launches_parts",
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
