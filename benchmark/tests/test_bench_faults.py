"""A run whose timed path is broken underneath must come out not correct,
once for each fault a training cell can have: a step that returns its state
unchanged, or its teacher alone (the EMA skipped), half of the batch left
out (the loss the mean over the rest), an answer altered where it is
produced (a label of the loaders' batch, the novel classes of the mined
candidates, the queue). The exchange between chips does not exist in a
one-chip cell. Driven on the CPU
at the tiny size, past the harness's look for a chip."""

import copy
import time

import numpy as np
import pytest
import torch

from benchmark import run


def _run(cell):
    return run.measure(cell, 77, 1.0, False, torch.device("cpu"), time.perf_counter())


def _failed(out) -> set:
    return {k for k, v in out["checks"].items() if not v["value"] <= v["limit"]}


def test_state_left_unchanged(tiny_cell, monkeypatch):
    from gcdlss_tpu_torch.train import modules

    real = modules.discover_train_step

    def unchanged(state, *a, **k):
        saved = (copy.deepcopy(state.student.state_dict()),
                 copy.deepcopy(state.teacher.state_dict()), state.tau.detach().clone(),
                 copy.deepcopy(state.optimizer.state_dict()), state.queue, state.step)
        state, metrics = real(state, *a, **k)
        state.student.load_state_dict(saved[0])
        state.teacher.load_state_dict(saved[1])
        with torch.no_grad():
            state.tau.copy_(saved[2])
        state.optimizer.load_state_dict(saved[3])
        state.queue, state.step = saved[4], saved[5]
        return state, metrics

    monkeypatch.setattr(modules, "discover_train_step", unchanged)
    out = _run(tiny_cell)
    assert not out["result"]["correct"]
    assert {"grad_gap", "change_gap", "stats1_gap"} <= _failed(out)


def test_teacher_left_unchanged(tiny_cell, monkeypatch):
    """The EMA skipped: the student steps, the teacher's parameters stay."""
    from gcdlss_tpu_torch.train import modules

    real = modules.discover_train_step

    def no_ema(state, *a, **k):
        saved = [p.detach().clone() for p in state.teacher.parameters()]
        state, metrics = real(state, *a, **k)
        with torch.no_grad():
            for p, s in zip(state.teacher.parameters(), saved):
                p.copy_(s)
        return state, metrics

    monkeypatch.setattr(modules, "discover_train_step", no_ema)
    out = _run(tiny_cell)
    assert not out["result"]["correct"]
    assert "change_gap" in _failed(out)
    assert out["run"]["numbers"]["teacher_change_gap"] > 0.9


def test_novel_match_reversed(tiny_cell, monkeypatch):
    """The Hungarian match picks the worst permutation, not the best."""
    from gcdlss_tpu_torch.train import discover

    real = discover.hungarian_small
    monkeypatch.setattr(discover, "hungarian_small",
                        lambda cost, maximize=True: real(cost, maximize=not maximize))
    out = _run(tiny_cell)
    assert not out["result"]["correct"]
    assert "mining_gap" in _failed(out)


def test_queue_not_pushed(tiny_cell, monkeypatch):
    """The reliable candidates never reach the queue."""
    from gcdlss_tpu_torch.train import discover

    monkeypatch.setattr(discover, "queue_push", lambda q, feats, valid: q)
    out = _run(tiny_cell)
    assert not out["result"]["correct"]
    assert "queue_gap" in _failed(out)


def test_half_the_batch_left_out(tiny_cell, monkeypatch):
    from gcdlss_tpu_torch.train import modules

    real = modules.discover_train_step
    scans = tiny_cell["cfg"]["scans_per_side"]

    def half(state, sup, unsup, cfg, **k):
        def drop(vb):
            return dict(vb, valid=vb["valid"] & (vb["coords"][:, 0] < scans // 2))

        return real(state, drop(sup), drop(unsup), cfg, **k)

    monkeypatch.setattr(modules, "discover_train_step", half)
    out = _run(tiny_cell)
    assert not out["result"]["correct"]
    assert "n_cand_gap" in _failed(out)


def test_answer_altered_where_produced(tiny_cell, monkeypatch):
    from gcdlss_tpu_torch.data import loader

    real = loader.collate_batch

    def altered(*a, **k):
        out = real(*a, **k)
        vb = out["voxel"]
        mapped = vb.mapped_labels.copy()
        mapped[0] = (mapped[0] + 1) % 17
        out["voxel"] = vb._replace(mapped_labels=mapped)
        return out

    monkeypatch.setattr(loader, "collate_batch", altered)
    out = _run(tiny_cell)
    assert not out["result"]["correct"]
    assert "loader_mismatch" in _failed(out)


def test_sound_run_passes(tiny_cell):
    out = _run(tiny_cell)
    assert out["result"]["correct"], out["checks"]
    assert np.isfinite(out["run"]["window_s"])


@pytest.mark.parametrize("kind", ["fp8", "half"])
def test_controls_fail_at_the_tiny_size(tiny_cell, kind):
    """The reference, made worse, in the program's place (`control.py`)."""
    from benchmark.reference import quant

    nums = tiny_cell["entry"].control(tiny_cell["cfg"], 3, torch.device("cpu"),
                                      quant=quant.CONTROLS.get(kind), drop_half=kind == "half")
    limits = tiny_cell["limits"]
    assert any(nums[k] > v for k, v in limits.items() if k in nums), nums
