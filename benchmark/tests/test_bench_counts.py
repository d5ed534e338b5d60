"""The yardstick's arithmetic: operations and bytes from a plan, the
roofline bound, and the busy time of a trace."""

import pytest
import torch

from benchmark import counts, peaks, trace
from benchmark.reference import minkunet
from benchmark.reference.sparse import Plan, cube_book


def _plan():
    # two voxels side by side in z, and one two cells away in x, of one scan
    coords = torch.tensor([[0, 0, 0, 0], [0, 0, 0, 1], [0, 2, 0, 0]])
    return Plan(coords, (8, 8, 8, 8, 8))


def test_cube_book_pairs_by_hand():
    plan = _plan()
    # k = 3: each voxel sees itself (3) and the z pair each other (2)
    assert counts.pairs(plan.cube[0]) == 5
    # the 125-offset stem sees every pair within 2 cells: all 9 ordered pairs
    assert counts.pairs(plan.stem) == 9
    # every level-0 voxel has one parent: 3 pairs on edge 0; the z pair
    # shares the parent (0, 0, 0, 0), the third has (0, 1, 0, 0)
    assert counts.pairs(plan.down[0]) == 3 and plan.levels[1].n == 2


def test_cube_book_offsets_are_product_order_z_fastest():
    plan = _plan()
    book = cube_book(plan.levels[0], 3)
    centre = 13
    out, inp = book[centre]
    assert out.tolist() == inp.tolist() == [0, 1, 2]
    out, inp = book[centre + 1]  # offset (0, 0, +1): row 0 reads row 1
    assert out.tolist() == [0] and inp.tolist() == [1]
    assert book[centre + 9][0].numel() == 0  # offset (+1, 0, 0): no voxel there
    out, inp = cube_book(plan.levels[0], 5)[62 + 50]  # (+2, 0, 0): row 0 reads row 2
    assert out.tolist() == [0] and inp.tolist() == [2]


def test_conv_work_by_hand():
    # 7 pairs, 27 offsets, 4 -> 8 channels, 3 rows, bf16 operands
    parts = dict((p, (o, b)) for p, o, b in counts.conv_work(7, 27, 4, 8, 3, 3, 2, grad=True))
    assert parts["fwd"][0] == parts["dx"][0] == parts["dw"][0] == 2 * 7 * 4 * 8
    assert parts["fwd"][1] == 3 * 4 * 2 + 27 * 4 * 8 * 2 + 3 * 27 * 4 + 3 * 8 * 2
    assert parts["dw"][1] == (3 * 4 + 3 * 8) * 2 + 3 * 27 * 4 + 27 * 4 * 8 * 4
    assert [p for p, _, _ in counts.conv_work(7, 27, 4, 8, 3, 3, grad=True, need_dx=False)] \
        == ["fwd", "dw"]


def test_pass_counts_forward_and_backward():
    plan = _plan()
    cfg = dict(arch="MinkUNet14", planes=[8, 8, 8, 8, 8, 8, 8, 8], blocks=[1] * 8, init_dim=8,
               in_channels=1, num_known=2, ncc_heads=1, num_novel=1)
    fwd = minkunet.pass_work(plan, cfg, grad=False)
    both = minkunet.pass_work(plan, cfg, grad=True)
    stem = 2 * counts.pairs(plan.stem) * 1 * 8
    # backward adds dX and dW to every conv but the stem, which adds dW only
    assert both["conv_ops"] == 3 * fwd["conv_ops"] - stem
    step = counts.stage2_step(plan, plan, cfg, minkunet.pass_work)
    assert step["conv_ops"] == fwd["conv_ops"] + 2 * both["conv_ops"]


def test_bound_takes_the_slower_of_bytes_and_operations():
    ms, by = peaks.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = peaks.bound_ms(1.0, 989e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_busy_is_the_union_of_device_events():
    ev = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 5.0, "dur": 10.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 30.0, "dur": 5.0},
          {"ph": "X", "cat": "user_annotation", "name": "bench/window", "ts": 0.0, "dur": 40.0},
          {"ph": "X", "cat": "user_annotation", "name": "discover/plan", "ts": 14.0, "dur": 20.0}]
    tr = trace.Trace(ev)
    lo, hi = tr.window("bench/window")
    assert trace.busy_us(tr.intervals(lo, hi), lo, hi) == 20.0
    assert tr.by_kernel(lo, hi) == {"a": 10.0, "b": 10.0, "c": 5.0}
    gaps = tr.idle_gaps(lo, hi)
    assert gaps[0] == ("discover/plan", 15.0 / 1e6) and gaps[1][1] == 5.0 / 1e6


def test_span_device_time_follows_the_launch():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "discover/plan", "ts": 0.0, "dur": 10.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 2.0, "dur": 1.0,
           "args": {"correlation": 7}},
          {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 12.0, "dur": 1.0,
           "args": {"correlation": 8}},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 20.0, "dur": 4.0,
           "args": {"correlation": 7}},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 30.0, "dur": 6.0,
           "args": {"correlation": 8}}]
    assert trace.Trace(ev).span_device_us("discover/plan") == 4.0
