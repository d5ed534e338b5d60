"""The comparison's controls at a cell's own size, on the card:

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 --kind fp8 half

For each seed and kind, one line of the compared numbers with the reference,
made worse, in the program's place: `fp8` (every product's operands in
float8 e4m3, the precision below the configuration's bf16), `bf16` (a
yardstick for the program's own rounding) or `half` (half of each side's
scans left out, the loss the mean over the rest). Not run by the benchmark's
runs; its readings set the upper ends of the limits (PERF.md).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kind", nargs="+", choices=("fp8", "bf16", "half"), required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run
    from benchmark.reference import quant

    run.set_caches()
    c = run.cell(run.load_spec(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        for kind in args.kind:
            nums = c["entry"].control(c["cfg"], seed, dev, quant=quant.CONTROLS.get(kind),
                                      drop_half=kind == "half")
            print(json.dumps({"seed": seed, "kind": kind, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
