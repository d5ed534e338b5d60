"""A run of the cell rehearsed on the CPU at a tiny size (`conftest.TINY`):
the files found by name, the program on its kernels' plain paths, the
window, the reference and the comparison, the per-layer readers; and the
refusals of `run.py` itself."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]


def test_names_and_units_use_only_allowed_characters():
    spec = run.load_spec()
    assert spec["command"] == ["python3", "benchmark/run.py"]
    for w in spec["workloads"]:
        c = run.cell(spec, w["name"])
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        for m in c["per_layer"]:
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
            assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    bad = dict(spec, per_layer=spec["per_layer"] + [
        {"name": "a b", "unit": "tokens per second"}])
    p = ROOT / "build" / "bad_benchmark.json"
    p.parent.mkdir(exist_ok=True)
    p.write_text(json.dumps(bad))
    try:
        with pytest.raises(ValueError, match="not allowed"):
            run.load_spec(p)
    finally:
        p.unlink()


def test_tiny_run_is_correct(tiny_cell):
    out = run.measure(tiny_cell, 2 ** 31 + 11, 1.0, False, torch.device("cpu"),
                      time.perf_counter())
    res = out["result"]
    assert res["correct"], out["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in tiny_cell["end_to_end"]}
    assert {"peak_mem_gib", "setup_s"} < set(res["metrics"])
    assert out["checks"]["loader_mismatch"]["value"] == 0
    assert list(out["checks"])[-1] == "change_gap"
    # the host's load beside the run: printed, never compared
    summary = json.loads(tiny_cell["entry"].summary(out["run"]))
    assert {"host_load_start", "host_load_end", "host_spin_ms", "window_cpu_s"} <= set(summary)
    assert summary["window_cpu_s"] > 0 and min(summary["host_spin_ms"]) > 0


def test_tiny_traced_run_reads_every_metric_it_can(tiny_cell):
    out = run.measure(tiny_cell, 5, 1.0, True, torch.device("cpu"), time.perf_counter())
    base = set(out["result"]["metrics"])
    # the CPU has no device events: only host readings and counts come out;
    # a percentile needs two steps
    assert {"loader_wait_ms", "step_mfu"} <= base
    assert ("step_ms_p90" in base) == (out["result"]["attempted"] >= 2)
    assert not {"plan_ms", "mining_ms", "idle_share", "conv_roofline"} & base
    assert base <= {x["name"] for x in tiny_cell["per_layer"]}
    assert out["inputs"]["work"]["conv_ops"] > 0
    bd = run.breakdown(out["inputs"])
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "s2.minkunet34.lasermix",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip().startswith("{")


def test_run_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(ROOT / "benchmark"), str(tmp_path)], check=True)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "s2.minkunet34.lasermix",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout
