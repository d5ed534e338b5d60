"""The readers of the program's spans on a hand-made chrome trace with known
answers: idle time inside the plans, copies between host and device, conv spans nested in
the passes with a `conv/bwd` on autograd's thread, the loader's and the
copies' spans; and every reader that was there before them reading the same
with and without the new spans."""

import pytest

from benchmark import run, spans, trace

NEW = {"loader_get_ms", "h2d_ms", "plan_idle_ms", "host_copies", "glue_ms"}
SPEC = run.load_spec()
OLD = sorted({m["name"] for m in SPEC["per_layer"]} - NEW)
MAIN, AUTOGRAD = 1, 2  # thread ids


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launched(corr, launch_ts, kernel_ts, dur, name="k", tid=MAIN, cat="kernel"):
    """A runtime launch at launch_ts and the device event it made."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_ts,
             "dur": 1.0, "tid": tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": name, "ts": kernel_ts, "dur": dur,
             "args": {"correlation": corr}}]


def _events():
    """Two steps in a 1,000 us window."""
    ev = [_span("bench/window", 0.0, 1000.0),
          _span("discover/plan", 100.0, 100.0), _span("discover/mix_plan", 400.0, 50.0),
          _span("discover/teacher", 200.0, 100.0), _span("discover/backward", 500.0, 200.0),
          _span("step", 90.0, 700.0)]
    # the plans: 30 us busy in the first (idle 70), 10 in the second (idle 40)
    ev += _launched(1, 110.0, 120.0, 30.0, "cube_map_kernel")
    ev += _launched(2, 395.0, 400.0, 10.0)
    # the teacher's pass: glue 10 us, one conv 20 us inside `conv/fwd`
    ev += [_span("conv/fwd", 220.0, 20.0)]
    ev += _launched(3, 210.0, 300.0, 10.0)
    ev += _launched(4, 225.0, 310.0, 20.0, "gather_gemm_kernel<128>")
    # the backward: the conv's 30 us on autograd's thread inside `conv/bwd`,
    # 15 us of glue launched on that thread outside it
    ev += [_span("conv/bwd", 550.0, 30.0, AUTOGRAD)]
    ev += _launched(5, 560.0, 590.0, 30.0, "gather_dw_kernel<64>", AUTOGRAD)
    ev += _launched(6, 600.0, 625.0, 15.0, tid=AUTOGRAD)
    # copies: two between host and device in the window, one device to
    # device, one after the window
    ev += _launched(7, 49.0, 50.0, 5.0, "Memcpy HtoD (Pageable -> Device)", cat="gpu_memcpy")
    ev += _launched(8, 799.0, 800.0, 2.0, "Memcpy DtoH (Device -> Pinned)", cat="gpu_memcpy")
    ev += _launched(9, 809.0, 810.0, 1.0, "Memcpy DtoD (Device -> Device)", cat="gpu_memcpy")
    ev += _launched(10, 1499.0, 1500.0, 1.0, "Memcpy HtoD (Pageable -> Device)",
                    cat="gpu_memcpy")
    # the loaders' takes (20 + 10 us; one after the window) and the copies' spans
    ev += [_span("loader/get", 10.0, 20.0), _span("loader/get", 600.0, 10.0),
           _span("loader/get", 1200.0, 5.0), _span("step/fetch", 5.0, 30.0),
           _span("step/to_device", 40.0, 20.0), _span("step/to_device", 700.0, 40.0),
           _span("plan/maps", 130.0, 30.0), _span("step/read", 760.0, 20.0)]
    return ev


def _inputs(events) -> dict:
    """What `entries.stage2_discover.per_layer_inputs` hands the readers."""
    tr = trace.Trace(events)
    lo, hi = tr.window("bench/window")
    return {"cfg": {}, "window_s": 1e-3, "steps": 2, "step_ms": [0.4, 0.5],
            "loader_wait_s": [2e-5, 1e-5], "launches": {"K1": 4},
            "work": {"steps": 2, "model_ops": 1e6, "conv_ops": 1e5, "conv_bound_ms": 1e-3},
            "trace": tr, "window_us": (lo, hi), "traced_window_s": (hi - lo) / 1e6,
            "busy_s": trace.busy_us(tr.intervals(lo, hi), lo, hi) / 1e6}


def _read(name, inp):
    return run._module(run.BENCH / "metrics" / f"{name}.py").read(inp)


def _without_new_spans(events):
    own = ("step", "loader/", "plan/", "conv/")
    return [e for e in events if not (e.get("cat") == "user_annotation"
                                      and e["name"].startswith(own))]


@pytest.mark.parametrize("name,value", [("loader_get_ms", 0.015), ("h2d_ms", 0.03),
                                        ("plan_idle_ms", 0.055), ("host_copies", 1.0),
                                        ("glue_ms", 0.0125)])
def test_each_new_reader_reads_its_value(name, value):
    assert _read(name, _inputs(_events())) == pytest.approx(value, abs=1e-12)


def test_glue_lies_between_zero_and_the_passes_device_time():
    tr = _inputs(_events())["trace"]
    passes = sum(tr.span_device_us(p) for p in spans.PASSES)
    assert passes == 75.0 and 0 < spans.glue_us(tr) == 25.0 < passes


@pytest.mark.parametrize("name", OLD)
def test_old_readers_read_the_same_without_the_new_spans(name):
    events = _events()
    with_new, without = _read(name, _inputs(events)), _read(name, _inputs(
        _without_new_spans(events)))
    assert with_new == without


@pytest.mark.parametrize("name,reads", [("loader_get_ms", False), ("h2d_ms", False),
                                        ("glue_ms", False), ("plan_idle_ms", True),
                                        ("host_copies", True)])
def test_on_a_program_without_the_spans(name, reads):
    """A program that opens only `discover/*` (the one before these spans):
    the readers of spans it lacks read nothing, and none raises."""
    got = _read(name, _inputs(_without_new_spans(_events())))
    assert (got is not None) == reads


@pytest.mark.parametrize("name", sorted(NEW))
def test_on_a_host_only_trace(name):
    """The CPU's trace has no device events: only the host's spans read."""
    events = [e for e in _events() if e["cat"] in ("user_annotation", "cuda_runtime")]
    got = _read(name, _inputs(events))
    assert (got is not None) == (name in ("loader_get_ms", "h2d_ms"))


def test_idle_gaps_name_the_program_spans():
    """The breakdown's labels, by the harness's own rule: the innermost span
    open where a gap begins, on any thread."""
    inp = _inputs(_events())
    labels = {n for n, _ in run.breakdown(inp)["idle_gaps"]}
    assert labels <= {"step", "step/fetch", "loader/get", "step/to_device", "discover/plan",
                      "plan/maps", "discover/mix_plan", "discover/teacher", "conv/fwd",
                      "discover/backward", "conv/bwd", "step/read", "idle host"}
    assert "plan/maps" in labels  # the plan's gap at 150 us is put down to its maps


def test_idle_split_puts_every_gap_down_to_a_label():
    from benchmark import idle_split

    inp = _inputs(_events())
    tr, (lo, hi) = inp["trace"], inp["window_us"]
    got = idle_split.idle_by_label(tr, lo, hi)
    us = {k: v * 1e6 for k, v in got["by_label_s"].items()}
    assert us == pytest.approx({"idle host": 247.0, "plan/maps": 150.0, "discover/mix_plan": 180.0,
                                "discover/backward": 165.0, "step": 70.0,
                                "step/to_device": 65.0})
    assert got["idle_s"] * 1e6 == pytest.approx(1000.0 - 123.0)
    assert got["first_gap_ms"] == [["idle host", pytest.approx(0.05)]]
    assert idle_split.conv_spans_outside_passes(tr, lo, hi) == 0
    stray = trace.Trace(_events() + [_span("conv/fwd", 900.0, 5.0)])
    assert idle_split.conv_spans_outside_passes(stray, lo, hi) == 1
