"""How much of a sparse conv's work a skip per strip of rows can save.

Run from the repository root:

    python3 -m gcdlss_tpu_torch.tools.strip_occupancy [--device cpu] [--stage 1|2]

Builds the plan `chip_smoke.py` holds K1/K2 against (Stage 2: 2 + 2 synthetic
80k-point scans at 0.05 m voxels, cap0 = 276,480, seed 3; Stage 1: 2 scans,
cap0 = 138,240, seed 0) and prints, for every kind of book on the MinkUNet
path, its fill (share of present entries) and the share of (strip of h
consecutive rows, offset) pairs that hold at least one present entry, for
h = 8 .. 128 (`ops.conv.strips_kept_plain`). K1 skips per strip of 16 rows;
a skip per 128-row block would keep the share under h = 128; only a
fill-only reduction, as dW's, reaches the fill. One JSON line per book.
The counts depend on the data only, not on the device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.conv import strips_kept_plain
from ..ops.plan import build_unet_plan
from ..train.common import default_caps, resolve_device

STRIPS = (8, 16, 32, 64, 128)


def occupancy(nbr: torch.Tensor) -> dict:
    out = {"rows": nbr.shape[0], "k": nbr.shape[1], "fill": float((nbr >= 0).float().mean())}
    for h in STRIPS:
        out[f"h{h}"] = float(strips_kept_plain(nbr, h).float().mean())
    return out


def books(plan) -> list:
    """(name, book) for the stem, each level's k3 map and each pool's pair."""
    out = [("stem L0 k5", plan.stem_nbr)]
    out += [(f"L{i} k3", lv.nbr3) for i, lv in enumerate(plan.levels)]
    for i, pool in enumerate(plan.pools):
        out.append((f"pool children L{i}->L{i + 1}", pool.children))
        out.append((f"pool upmap L{i + 1}->L{i}", pool.upmap))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stage", type=int, choices=(1, 2), default=2)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    import chip_smoke as cs

    cap0, seed, sides = ((cs.CAP0, 0, 1), (cs.S2_CAP0, 3, 2))[args.stage - 1]
    coords, valid = cs.voxel_batch(np.random.default_rng(seed), device, sides=sides)
    plan = build_unet_plan(coords, valid, default_caps(cap0), presorted=True)
    print(f"{'book':<28}{'rows':>8}{'K':>5}{'fill':>7}" + "".join(f"{'h=' + str(h):>7}" for h in STRIPS))
    for name, nbr in books(plan):
        r = occupancy(nbr)
        print(f"{name:<28}{r['rows']:>8}{r['k']:>5}{r['fill']:>7.3f}"
              + "".join(f"{r[f'h{h}']:>7.2f}" for h in STRIPS))
        print(json.dumps({"book": name, "stage": args.stage, **r}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
