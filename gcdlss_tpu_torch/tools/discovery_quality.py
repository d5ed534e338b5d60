"""End-to-end discovery quality of the port (the twin of the JAX package's
`tools/discovery_quality.py`).

Shows that the port's Stage-2 machinery *discovers*, not only that its steps
match the JAX ones: on a synthetic SemanticKITTI tree whose classes are
geometrically separable and whose split-1 held-out classes are distinctive
(`data/synthetic.write_learnable_kitti`), run Stage-1 pretraining and then
the default Stage-2 recipe through the port's CLI
(`gcdlss_tpu_torch.main.main`, what `python -m gcdlss_tpu_torch.main`
runs), and record the per-epoch `valid/mIoU_new` and `valid/mIoU_old`
curves. The novel head starts untrained, so mIoU_new starts near 0.

    python3 -m gcdlss_tpu_torch.tools.discovery_quality --workdir build/dq
    python3 -m gcdlss_tpu_torch.tools.discovery_quality --device cpu --workdir /tmp/dq

Writes <workdir>/result.json with the JAX tool's keys (`stage1_loss`,
`stage1_miou`, `stage2_loss`, `stage2_miou_old`, `stage2_miou_new`,
`stage2_n_cand`), prints the port's curves beside the JAX package's
(`docs/discovery_quality_r3.json`, JAX on the CPU) and a verdict line. The
JAX curve is a yardstick, not a bound: `check` fails unless the port's last
Stage-2 mIoU_new is at least MIN_LAST_NEW and its best mIoU_old exceeds its
first. Runs on the card unless `--device` names another.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
JAX_CURVES = REPO / "docs" / "discovery_quality_r3.json"
MIN_LAST_NEW = 0.10
CURVES = {"stage1_loss": ("s1", "train/loss"), "stage1_miou": ("s1", "valid/mIoU"),
          "stage2_loss": ("s2", "train/loss"), "stage2_miou_old": ("s2", "valid/mIoU_old"),
          "stage2_miou_new": ("s2", "valid/mIoU_new"), "stage2_n_cand": ("s2", "train/n_cand")}


def read_jsonl(path: Path) -> list:
    if not path.exists():
        return []
    recs = []
    for line in path.read_text().splitlines():
        try:
            recs.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return recs


def curve(recs: list, tag: str) -> list:
    return [round(v, 4) for _, v in sorted((r["step"], r["value"]) for r in recs
                                           if r["tag"] == tag)]


def check(result: dict) -> list:
    """What keeps `result` from showing discovery (empty when nothing)."""
    new, old = result["stage2_miou_new"], result["stage2_miou_old"]
    faults = []
    if not new or new[-1] < MIN_LAST_NEW:
        faults.append(f"last Stage-2 mIoU_new {new[-1] if new else None} < {MIN_LAST_NEW}")
    if not old or max(old) <= old[0]:
        faults.append(f"best Stage-2 mIoU_old {max(old) if old else None} does not exceed the "
                      f"first {old[0] if old else None}")
    return faults


def side_by_side(result: dict, jax_curves: dict) -> str:
    """The port's Stage-2 curves beside the JAX package's, one epoch a line."""
    rows = ["epoch  port new  JAX new   port old  JAX old"]
    port_new, port_old = result["stage2_miou_new"], result["stage2_miou_old"]
    jax_new, jax_old = jax_curves.get("stage2_miou_new", []), jax_curves.get("stage2_miou_old", [])

    def cell(values, i):
        return f"{values[i]:8.4f}" if i < len(values) else " " * 8

    for i in range(max(len(port_new), len(jax_new))):
        rows.append(f"{i:5d}  {cell(port_new, i)}  {cell(jax_new, i)}  {cell(port_old, i)}  "
                    f"{cell(jax_old, i)}")
    return "\n".join(rows)


def run(workdir: str, stage1_epochs: int = 12, stage2_epochs: int = 15,
        scans_per_seq: int = 24, points: int = 4000, voxel_size: float = 0.15,
        voxel_cap: int = 4096, arch: str = "MinkUNet14", device: str = "cuda",
        num_workers: int = 2, force: bool = False) -> dict:
    """Write the tree (unless there), run Stage 1 and Stage 2 through the
    CLI, and return the curves (also written to <workdir>/result.json)."""
    from .. import main as cli
    from ..data.synthetic import write_learnable_kitti
    from ..train.common import resolve_device

    resolve_device(device)  # raises without a card unless the CPU is asked for
    work = Path(workdir)
    data_root = work / "kitti_learn"
    if force:
        shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True, exist_ok=True)
    if not (data_root / ".done").exists():
        write_learnable_kitti(str(data_root), sequences=("00", "01"),
                              scans_per_seq=scans_per_seq, num_points=points, valid_scans=8)
        (data_root / ".done").touch()
    common = ["-s", "1", "--dataset", "SemanticKITTI", "--dataset_path", str(data_root),
              "--batch_size", "2", "--num_workers", str(num_workers), "--downsampling",
              str(points), "--voxel_size", str(voxel_size), "--voxel_cap", str(voxel_cap),
              "--arch", arch, "--checkpoint_dir", str(work / "ckpt"), "--log_dir",
              str(work / "logs"), "--split_dir", str(work / "split"), "--device", device]
    s1_dir = work / "ckpt" / "s1"
    if not (s1_dir / "pretrained").exists():
        cli.main(common + ["--module", "ExpPretrain", "--experiment", "s1",
                           "--epochs", str(stage1_epochs)])
    shutil.rmtree(work / "ckpt" / "s2", ignore_errors=True)
    shutil.rmtree(work / "logs" / "s2", ignore_errors=True)
    cli.main(common + ["--module", "ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive",
                       "--experiment", "s2", "--epochs", str(stage2_epochs),
                       "--pretrained", str(s1_dir)])
    logs = {run: read_jsonl(work / "logs" / run / "metrics.jsonl") for run in ("s1", "s2")}
    result = {key: curve(logs[run], tag) for key, (run, tag) in CURVES.items()}
    (work / "result.json").write_text(json.dumps(result, indent=1))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gcdlss_tpu_torch.tools.discovery_quality")
    ap.add_argument("--workdir", default=str(REPO / "build" / "discovery_quality"))
    ap.add_argument("--stage1-epochs", type=int, default=12)
    ap.add_argument("--stage2-epochs", type=int, default=15)
    ap.add_argument("--scans-per-seq", type=int, default=24)
    ap.add_argument("--points", type=int, default=4000)
    ap.add_argument("--voxel-size", type=float, default=0.15)
    ap.add_argument("--voxel-cap", type=int, default=4096)
    ap.add_argument("--arch", default="MinkUNet14")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-workers", type=int, default=2)
    ap.add_argument("--force", action="store_true")
    a = ap.parse_args(argv)
    result = run(a.workdir, a.stage1_epochs, a.stage2_epochs, a.scans_per_seq, a.points,
                 a.voxel_size, a.voxel_cap, a.arch, a.device, a.num_workers, a.force)
    jax_curves = json.loads(JAX_CURVES.read_text()) if JAX_CURVES.exists() else {}
    print(json.dumps(result))
    print(side_by_side(result, jax_curves))
    new = result["stage2_miou_new"]
    faults = check(result)
    print(f"VERDICT: mIoU_new {new[0] if new else float('nan'):.3f} -> "
          f"{max(new) if new else float('nan'):.3f} (final {new[-1] if new else float('nan'):.3f})"
          f"; {'discovers' if not faults else 'FAILS: ' + '; '.join(faults)}", flush=True)
    return 1 if faults else 0


if __name__ == "__main__":
    raise SystemExit(main())
