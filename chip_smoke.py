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
     with CUDA events;
  3. Stage-2 kernels: the rank-based neighbor map K4 (`plan_kernel=1`) at
     the Stage-2 path's shapes (2 labeled + 2 unlabeled scans, cap0 =
     276,480), at L0 k5, L0 k3 and L1 k3, against its plain version, K3 and
     the join path, bit for bit, and timed beside K3 and the plain version;
     then K1/K2 at that plan's convs, as in phase 2;
  4. reference: MinkUNet34 forward (eval-mode batch norm) on a small input,
     on the card (kernels) and on the CPU (plain versions) with the same
     weights, relative error <= REF_TOL;
  5. conv parts: the component kernels P1-P4 of `ops/conv_parts.py` (window
     staging, gather, product, one-hot conv) and K1, every mode of
     `tools/conv_parts.py`, against their plain versions at the tool's two
     configurations (262,144 rows x 96 channels; 131,072 x 256); then the
     tool's own `main` at 262,144 x 96, every mode once;
  6. Stage-1 slice: `ExpPretrain` with MinkUNet34 in bf16, 3 steps at batch 2
     through the port's `SemanticKITTIDataset` and `PrefetchLoader`
     (per-scan seeds: the same batches, so the same losses, on every run),
     then `validate` on 2 scans;
  7. Stage-2 slice: `ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive` at the
     `bench.py` Stage-2 configuration (MinkUNet34, bf16, 2 + 2 scans), 3
     steps with `plan_kernel=2` and 1 with `plan_kernel=1` through its own
     loaders, then `validate` on 4 scans.

Each path (the tool's `main`, the Stage-1 slice, the Stage-2 slice) sets
every kernel's launch count to 0 just before it and reads it just after: each
kernel of its path must have launched. Every kernel row carries its bound,
the least time the card could take for the same work: the larger of its bytes
(each input read once, each output written once) over 3.35 TB/s and its
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


def kernel_phase(device) -> list:
    import torch

    from gcdlss_tpu_torch.ops.plan import build_unet_plan, join_neighbor_map
    from gcdlss_tpu_torch.ops.plan_kernel import cube_neighbor_map
    from gcdlss_tpu_torch.train.common import default_caps

    rng = np.random.default_rng(0)
    caps = default_caps(CAP0)
    coords, valid = voxel_batch(rng, device)
    plan = build_unet_plan(coords, valid, caps, presorted=True)
    torch.cuda.synchronize()
    log(f"plan: caps {caps}, valid rows per level "
        f"{[int(lv.valid.sum()) for lv in plan.levels]}")
    rows = []

    # K3: every map of the plan against the join path, bit for bit
    for lev, lv in enumerate(plan.levels):
        for k1 in ((5, 3) if lev == 0 else (3,)):
            got = cube_neighbor_map(lv.key_hi, lv.key_lo, k1)
            ref = join_neighbor_map(lv.key_hi, lv.key_lo, k1)
            mism = int((got != ref).sum())
            if lev == 0 and k1 == 5 and not torch.equal(got, plan.stem_nbr):
                raise AssertionError("K3: plan stem map differs from a fresh launch")
            line = f"K3 L{lev} k{k1}: cap {lv.key_hi.shape[0]} mismatches {mism}"
            if lev <= 1:
                ms = cuda_time_ms(lambda: cube_neighbor_map(lv.key_hi, lv.key_lo, k1))
                pms = cuda_time_ms(lambda: join_neighbor_map(lv.key_hi, lv.key_lo, k1))
                rows.append(dict(name=f"K3 cube_map L{lev} k{k1}", route="cuda",
                                 source="gcdlss_tpu_torch/csrc/cube_map.cu",
                                 replaces="gcdlss_tpu/ops/plan_kernel.py:378",
                                 max_abs_err=float(mism), ms=ms, plain_ms=pms,
                                 **bound(nbytes(lv.key_hi, lv.key_lo, got), 0)))
                line += f" | kernel {ms:.3f} ms, plain {pms:.3f} ms"
            log(line)
            if mism:
                raise AssertionError(f"K3 L{lev} k{k1}: {mism} entries differ from the join path")
    return rows + gemm_phase(plan, device, "stage1")


def gemm_phase(plan, device, tag: str) -> list:
    """K1/K2 at the path's convs of `plan` (stem, L0 and L3 k3, a down and
    an up pool book), each against its plain version on the same
    bf16-rounded inputs, timed beside it."""
    import torch

    from gcdlss_tpu_torch.ops import conv as plain
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm, gather_gemm_backward

    rows = []
    lv, pools = plan.levels, plan.pools
    cases = [  # name, x rows, fwd book, adjoint book, ci, co
        ("stem L0 k5 1->32", lv[0].valid, plan.stem_nbr, plan.stem_nbr.flip(1), 1, 32),
        ("L0 k3 128->96", lv[0].valid, lv[0].nbr3, lv[0].nbr3.flip(1), 128, 96),
        ("L3 k3 256->256", lv[3].valid, lv[3].nbr3, lv[3].nbr3.flip(1), 256, 256),
        ("down L0->L1 32->32", lv[0].valid, pools[0].children, pools[0].upmap, 32, 32),
        ("up L4->L3 256->256", lv[4].valid, pools[3].upmap, pools[3].children, 256, 256),
    ]
    for name, xvalid, nbr, adj, ci, co in cases:
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
        ms = cuda_time_ms(lambda: gather_gemm(x, nbr, w))
        pms = cuda_time_ms(lambda: plain.gather_conv(x, nbr, w))
        log(f"K1 {name}: max|d| {err:.3e} (max|ref| {scale:.3e}) | "
            f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
        if not err <= OUT_TOL * scale:
            raise AssertionError(f"K1 {name}: error {err} above {OUT_TOL} x {scale}")
        rows.append(dict(name=f"K1 gather_gemm {name}", route="cuda",
                         source="gcdlss_tpu_torch/csrc/gather_gemm.cu",
                         replaces="gcdlss_tpu/ops/fused_conv.py:312",
                         max_abs_err=err, ms=ms, plain_ms=pms, fill=nnz / nbr.numel(),
                         bound_dense_ms=max(dense, bound(nbytes(x, nbr, w, out), 0)["bound_ms"]),
                         **bound(nbytes(x, nbr, w, out), nnz * flops_entry)))

        dx, dw = gather_gemm_backward(x, g, adj, w)
        rdx, rdw = plain.gather_conv_backward(x, g, adj, w)
        dx_err = float((dx - rdx).abs().max())
        dx_scale = float(rdx.abs().max())
        dw_rel = float(torch.linalg.vector_norm(dw - rdw) / torch.linalg.vector_norm(rdw))
        ms = cuda_time_ms(lambda: gather_gemm_backward(x, g, adj, w))
        pms = cuda_time_ms(lambda: plain.gather_conv_backward(x, g, adj, w))
        log(f"K2 {name}: dX max|d| {dx_err:.3e} (max|ref| {dx_scale:.3e}), "
            f"dW rel-Frobenius {dw_rel:.3e} | kernel {ms:.3f} ms, plain {pms:.3f} ms")
        if not dx_err <= OUT_TOL * dx_scale:
            raise AssertionError(f"K2 {name}: dX error {dx_err} above {OUT_TOL} x {dx_scale}")
        if not dw_rel <= DW_TOL:
            raise AssertionError(f"K2 {name}: dW relative error {dw_rel} above {DW_TOL}")
        rows.append(dict(name=f"K2 gather_gemm_backward {name}", route="cuda",
                         source="gcdlss_tpu_torch/csrc/gather_gemm.cu",
                         replaces="gcdlss_tpu/ops/fused_conv.py:379",
                         max_abs_err=max(dx_err, float((dw - rdw).abs().max())),
                         ms=ms, plain_ms=pms, fill=nnz / nbr.numel(),
                         bound_dense_ms=max(2 * dense, bound(nbytes(x, g, adj, w, dx, dw), 0)["bound_ms"]),
                         **bound(nbytes(x, g, adj, w, dx, dw), 2 * nnz * flops_entry)))
    return rows


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
    return rows + gemm_phase(plan, device, "stage2")


def reference_phase(device) -> None:
    """MinkUNet34 forward on a small input: kernels on the card against the
    plain versions on the CPU, same weights, bf16 activations on both."""
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
                         voxel_caps=default_caps(cap0), dtype="bfloat16")
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
    log(f"reference: MinkUNet34 logits on {len(vc)} voxels, card vs CPU "
        f"rel-Frobenius {rel:.3e}, max|d| {err:.3e} (max|ref| {float(ref.abs().max()):.3e})")
    # both sides round every layer's output to bf16; a last-place flip where
    # the f32 sums differ in order propagates through the 34 layers, so the
    # bound is on the whole logit tensor, ~8x the order-flip spread above
    if not (torch.isfinite(got).all() and rel <= REF_TOL):
        raise AssertionError(f"reference: card logits differ from the CPU's by {rel} (relative)")


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
                            | {"library_ms": r["library_ms"]})

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
            f"time {s['seconds'] * 1e3:.1f} ms ({gpu_name})")
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

    rates_phase(device)
    rows = kernel_phase(device) + stage2_kernel_phase(device)
    reference_phase(device)
    part_rows, launches_parts = conv_parts_phase(device, card)
    launches_s1 = stage1_phase(device, gpu_name)
    launches_s2 = stage2_phase(device, gpu_name)
    # `launches`: K1-K4 on the Stage-2 path (the training path that runs all
    # four; `launches_stage1` the Stage-1 path), P1-P4 in the tool's main run
    # (their only path; K1's launches there are `launches_parts`)
    for r in rows:
        r["launches"] = launches_s2[r["name"][:2]]
        r["launches_stage1"] = launches_s1[r["name"][:2]]
        if r["name"][:2] == "K1":
            r["launches_parts"] = launches_parts["K1"]
    for r in part_rows:
        r["launches"] = launches_parts[r["name"][:2]]
    rows += part_rows
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    extra = ("launches_stage1", "launches_parts", "bound_measured_ms", "bound_dense_ms", "fill",
             "ranks_plus_kernel_ms", "k3_ms")
    missing = [(r["name"], k) for r in rows for k in keys if k not in r]
    if missing:
        raise AssertionError(f"kernel rows lack keys: {missing}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": gpu_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
