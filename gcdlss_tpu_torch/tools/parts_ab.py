"""Time the gather P2 (every mode) and the one-hot conv P4, with K1 beside it,
of one source tree on one CUDA device: one leg of an A/B of two trees.

Run as a script, naming the tree whose `gcdlss_tpu_torch` to time (each tree
builds its own kernels under its `build/kernels/`):

    python3 gcdlss_tpu_torch/tools/parts_ab.py --root build/parent --json-out build/ab_parent_1.json
    python3 gcdlss_tpu_torch/tools/parts_ab.py --root . --json-out build/ab_change_1.json

To compare two trees, run it in one call on one card in turns: parent,
change, change, parent. The inputs are the conv-parts tool's at its two
configurations (`tools/conv_parts.py`: level-0 books of synthetic scans,
seed 0). Each row is the median of `--reps` single launches through the
wrapper, timed with CUDA events after two warm-ups. Prints one JSON line per
row and the card's name and power limit; raises without a CUDA device.
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
        timed = [(f"P2 {index} {'unrolled' if unroll else 'rolled'}",
                  lambda index=index, unroll=unroll: cp.gather_sum(x, nbr, index, unroll))
                 for index in cp.INDEX_MODES for unroll in (False, True)]
        timed += [("P4 onehot", lambda: cp.onehot_conv(x, nbr, w)),
                  ("K1 full", lambda: gather_gemm(x, nbr, w))]
        for name, fn in timed:
            row = dict(tree=str(args.root), rows=n, channels=c, name=name, ms=median_ms(fn),
                       reps=args.reps, device=card)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.json_out:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
