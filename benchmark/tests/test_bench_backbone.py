"""A backbone joins the Stage-2 cell by name: the configuration's
`reference_model` picks the reference module whose `spec`, `forward` and
`pass_work` the run takes, and a name with no file, like a cell with no CPU
cut, raises and names the file it looked for."""

import sys
import time
import types

import pytest
import torch

from benchmark import run
from benchmark.reference import minkunet
from benchmark.tests import conftest

CPU = torch.device("cpu")
CONTRACT = ("spec", "forward", "pass_work")


def _measure(cell, trace):
    return run.measure(cell, 2 ** 31 + 23, 1.0, trace, CPU, time.perf_counter())


def test_a_backbone_joins_by_name(tiny_cell, monkeypatch):
    """A module registered as `benchmark.reference.counted` forwards to
    MinkUNet's and counts its calls: a run whose configuration names it
    calls that module alone, and compares the same numbers as the plain run."""
    calls = dict.fromkeys(CONTRACT, 0)
    counted = types.ModuleType("benchmark.reference.counted")

    def forwarding(name):
        def call(*a, **k):
            calls[name] += 1
            return getattr(minkunet, name)(*a, **k)
        return call

    for name in CONTRACT:
        setattr(counted, name, forwarding(name))
    monkeypatch.setitem(sys.modules, counted.__name__, counted)
    plain = _measure(tiny_cell, False)
    assert calls == dict.fromkeys(CONTRACT, 0)
    out = _measure(dict(tiny_cell, cfg=dict(tiny_cell["cfg"], reference_model="counted")), True)
    steps = out["inputs"]["work"]["steps"]
    assert steps >= 1
    assert calls == {"spec": 1, "forward": 3 * tiny_cell["cfg"]["checked_steps"],
                     "pass_work": 3 * steps}
    assert out["run"]["numbers"] == plain["run"]["numbers"]
    assert out["result"]["correct"], out["checks"]


def test_an_unknown_reference_model_names_its_file(tiny_cell):
    cell = dict(tiny_cell, cfg=dict(tiny_cell["cfg"], reference_model="no_such_backbone"))
    with pytest.raises(FileNotFoundError, match=r"reference/no_such_backbone\.py"):
        _measure(cell, False)


def test_a_cell_without_a_cut_file_names_it():
    with pytest.raises(FileNotFoundError, match=r"tests/cuts/s2\.no_such_cell\.json"):
        conftest.cut("s2.no_such_cell")
