"""Shared fixtures of the benchmark's own tests (run from the repository
root: `python -m pytest benchmark/tests -q`)."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import run

CUTS = Path(__file__).resolve().parent / "cuts"
# every cell cut to a size the CPU runs in seconds: four 3,000-point scans a
# step, small capacities; each cell's own cut of its model (narrow widths, a
# shallower sibling) is data, `cuts/<cell>.json`; every other setting is the
# cell's own
TINY = dict(points_per_scan=3000, downsampling=2000, distinct_scans=4, repeat=20,
            voxel_caps=[8192] * 5, mix_voxel_caps=[8192] * 5, caps=(8192,) * 5,
            mix_caps=(8192,) * 5, sup_voxel_cap=4096, queue_per_slot=64, num_workers=2)


def cut(workload: str) -> dict:
    """The cell's CPU cut, `cuts/<cell>.json`; a cell without one raises
    FileNotFoundError naming the file."""
    return json.loads((CUTS / f"{workload}.json").read_text())


@pytest.fixture(params=[w["name"] for w in run.load_spec()["workloads"]])
def tiny_cell(request):
    """Each cell of BENCHMARK.json as `run.cell` finds it, cut to TINY and its
    own cut, on two CPU threads."""
    c = run.cell(run.load_spec(), request.param)
    c["cfg"].update(TINY, **cut(request.param))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield c
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
