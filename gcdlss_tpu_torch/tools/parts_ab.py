"""Time the window staging P1 and the gather P2 (every mode), the one-hot conv
P4 with K1 beside it, and the rank-based neighbor map K4, of one source tree
on one CUDA device: one leg of an A/B of two trees.

Run as a script, naming the tree whose `gcdlss_tpu_torch` to time (each tree
builds its own kernels under its `build/kernels/`):

    python3 gcdlss_tpu_torch/tools/parts_ab.py --root build/parent --json-out build/ab_parent_1.json
    python3 gcdlss_tpu_torch/tools/parts_ab.py --root . --json-out build/ab_change_1.json

To compare two trees, run it in one call on one card in turns: parent,
change, change, parent. The inputs of P1, P2, P4 and K1 are the conv-parts
tool's at its two configurations (`tools/conv_parts.py`: level-0 books of
synthetic scans, seed 0; P1 in every layout, window, buffer count and start
pattern of the tool); K4's are the maps L0 k5, L0 k3 and L1 k3 of the
Stage-2 plan of `chip_smoke.py` (2 + 2 synthetic scans, cap0 = 276,480),
the kernel alone and with its ranks pass (`plan._column_ranks`). Each row is
the median of `--reps` single launches through the wrapper, timed with CUDA
events after two warm-ups. Prints one JSON line per row and the card's name
and power limit; raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HOLD_CYCLES = 200_000  # the spin ahead of each timed call (the conv-parts tool's)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True, help="tree whose package is timed")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--json-out", type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from gcdlss_tpu_torch.ops import conv_parts as cp
    from gcdlss_tpu_torch.ops.fused_conv import gather_gemm
    from gcdlss_tpu_torch.tools import conv_parts as tool

    if not torch.cuda.is_available():
        raise SystemExit("parts_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    def median_ms(fn) -> float:
        """Device time: a spin kernel ahead of the start event lets the host
        queue the call before the card reaches the event."""
        for _ in range(2):
            fn()
        times = []
        for _ in range(args.reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    rows = []
    for n, c, voxel in tool.DEFAULT_CONFIGS:
        nbr, valid, _ = tool.level0_book(n, voxel, 0, dev)
        g = torch.Generator().manual_seed(0)
        x = (torch.randn(n, c, generator=g).to(dev) * valid[:, None]).to(torch.bfloat16)
        w = (torch.randn(tool.K, c, c, generator=g) * (2.0 / (tool.K * c)) ** 0.5
             ).to(dev).to(torch.bfloat16)
        timed = []
        for lay in cp.LAYOUTS:
            held = cp.to_layout(x, lay)
            for win in tool.WINDOWS:
                for rand in (False, True):
                    ws = cp.window_starts(n, tool.BLOCK, win, random=rand, align=8).to(dev)
                    for buf in (1, 2):
                        timed.append((f"P1 {lay} W{win} {'random' if rand else 'sequential'} "
                                      f"buffers {buf}",
                                      lambda t=held, ws=ws, win=win, lay=lay, buf=buf:
                                          cp.window_sum(t, ws, win, lay, buf)))
        timed += [(f"P2 {index} {'unrolled' if unroll else 'rolled'}",
                   lambda index=index, unroll=unroll: cp.gather_sum(x, nbr, index, unroll))
                  for index in cp.INDEX_MODES for unroll in (False, True)]
        timed += [("P4 onehot", lambda: cp.onehot_conv(x, nbr, w)),
                  ("K1 full", lambda: gather_gemm(x, nbr, w))]
        for name, fn in timed:
            row = dict(tree=str(args.root), rows=n, channels=c, name=name, ms=median_ms(fn),
                       reps=args.reps, device=card)
            rows.append(row)
            print(json.dumps(row), flush=True)
    rows += k4_rows(args.root, dev, median_ms, card, args.reps)
    if args.json_out:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(rows))
    return 0


def k4_rows(root: Path, dev, median_ms, card: str, reps: int) -> list:
    """K4 at L0 k5, L0 k3 and L1 k3 of the Stage-2 plan: kernel alone, and
    ranks + kernel."""
    import numpy as np
    import torch

    import chip_smoke
    from gcdlss_tpu_torch.ops.coords import SENTINEL_HI
    from gcdlss_tpu_torch.ops.plan import _column_ranks, build_unet_plan
    from gcdlss_tpu_torch.ops.plan_kernel import cube_candidates_map
    from gcdlss_tpu_torch.train.common import default_caps

    coords, valid = chip_smoke.voxel_batch(np.random.default_rng(3), dev, sides=2)
    plan = build_unet_plan(coords, valid, default_caps(chip_smoke.S2_CAP0), presorted=True)
    torch.cuda.synchronize()
    rows = []
    for lev, k1 in ((0, 5), (0, 3), (1, 3)):
        kh, kl = plan.levels[lev].key_hi, plan.levels[lev].key_lo
        p, has = _column_ranks(kh != SENTINEL_HI, kh, kl, k1)
        for name, fn in (
                (f"K4 L{lev} k{k1} kernel", lambda: cube_candidates_map(kh, kl, p, has, k1)),
                (f"K4 L{lev} k{k1} ranks + kernel", lambda: cube_candidates_map(
                    kh, kl, *_column_ranks(kh != SENTINEL_HI, kh, kl, k1), k1))):
            row = dict(tree=str(root), cap=kh.shape[0], name=name, ms=median_ms(fn), reps=reps,
                       device=card)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
