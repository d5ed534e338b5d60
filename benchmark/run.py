"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. The cell, its configuration and traffic mix are found by name in
`BENCHMARK.json`: `configs/<config>.json`, `traffic/<traffic>.json`, the
limits of its comparison in `limits/<cell>.json`, the driver of its entry in
`entries/<entry>.py` and each per-layer metric's reader in
`metrics/<metric>.py`. With `--trace 0` the result carries the cell's
end-to-end metrics, with `--trace 1` its per-layer ones, read from a
profiler trace of the window. The last line of standard output is one JSON
object; the compared numbers and their limits are also the last lines of
standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gcdlss_tpu")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load_spec(path: Path = ROOT / "BENCHMARK.json") -> dict:
    """BENCHMARK.json, with every name and unit checked for its characters."""
    spec = json.loads(path.read_text())
    names = [c["name"] for c in spec["configs"]]
    for w in spec["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for c in spec["configs"]:
        names += list(c["reduced"])
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    bad = [n for n in names if not NAME.fullmatch(n)]
    bad += [m["unit"] for m in metrics if not UNIT.fullmatch(m["unit"])]
    if bad:
        raise ValueError(f"BENCHMARK.json: names or units with characters not allowed: {bad}")
    return spec


def _json(rel: str) -> dict:
    return json.loads((BENCH / rel).read_text())


def _module(path: Path):
    """A reader or driver by its file (a name may hold '.' or '-')."""
    name = "benchmark._loaded." + re.sub(r"\W", "_", str(path.relative_to(BENCH)))
    found = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(found)
    found.loader.exec_module(mod)
    return mod


def cell(spec: dict, workload: str) -> dict:
    """Everything of one cell, found by its names."""
    ws = {w["name"]: w for w in spec["workloads"]}
    if workload not in ws:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(ws)}")
    w = ws[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = _json(f"traffic/{w['traffic']}.json")
    entry = importlib.import_module(f"benchmark.entries.{config['entry']}")

    def applies(m):
        return workload in m.get("workloads", [workload])

    return {"workload": w, "config": config, "traffic": traffic, "entry": entry,
            "limits": _json(f"limits/{workload}.json"),
            "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
            "per_layer": [m for m in spec["per_layer"] if applies(m)],
            "cfg": entry.run_config(config, traffic)}


def set_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library loads JAX by itself; one BLAS / OpenMP thread in each of the
    loaders' threads, which would otherwise each start a pool as large as
    the host and take its cores from the process that launches the work."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def checks(res: dict, limits: dict) -> dict:
    """Each compared number beside its limit."""
    nums = dict(res["numbers"], nonfinite_steps=res["failed"])
    return {k: {"value": nums[k], "limit": limits[k]} for k in limits}


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def measure(c: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of cell `c` on `device`: the result object (without the
    device facts of the card) and the run's own record."""
    with tempfile.TemporaryDirectory(prefix="bench-run-") as tmp:
        res = c["entry"].run(c["cfg"], seed, seconds, trace, device, t_start, Path(tmp))
        if trace:
            inp = c["entry"].per_layer_inputs(res, c["cfg"])
            metrics = {}
            for m in c["per_layer"]:
                v = _module(BENCH / "metrics" / f"{m['name']}.py").read(inp)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            e2e = c["entry"].end_to_end(res, c["cfg"])
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in c["end_to_end"]}
            inp = None
    chk = checks(res, c["limits"])
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in chk.values())
    out = {"correct": correct, "attempted": res["steps"], "failed": res["failed"],
           "metrics": metrics}
    return {"result": out, "checks": chk, "run": res, "inputs": inp}


def breakdown(inp: dict) -> dict:
    tr, (lo, hi) = inp["trace"], inp["window_us"]
    ops = sorted(tr.by_kernel(lo, hi).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[n, s] for n, s in tr.idle_gaps(lo, hi)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    set_caches()
    spec = load_spec()
    c = cell(spec, args.workload)
    import torch

    need = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"run.py: the cell needs {need} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = power_limit()
    print(f"card: {card}", flush=True)
    out = measure(c, args.seed, args.seconds, bool(args.trace), device, T_START)
    res, result = out["run"], out["result"]
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": need,
                        "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        inp = out["inputs"]
        result["device"].update(busy_s=inp["busy_s"], window_s=inp["traced_window_s"])
        result["breakdown"] = breakdown(inp)
        spans = {n: inp["trace"].span_device_us(n) / 1e3 for n in sorted(inp["trace"].spans)
                 if n.startswith("discover/")}
        print("span device ms, window total: " + json.dumps(spans), flush=True)
        print("work: " + json.dumps(inp["work"]), flush=True)
    print("run: " + c["entry"].summary(res), flush=True)
    print("compared: " + json.dumps(res["numbers"]), flush=True)
    bad = forbidden_loaded()
    if bad:
        print(f"run.py: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    result["checks"] = out["checks"]
    for k, v in out["checks"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
