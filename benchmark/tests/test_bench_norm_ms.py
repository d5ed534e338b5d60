"""`norm_ms` on the hand-made chrome trace of `test_bench_spans.py`, with a
`norm/fwd` span in the teacher's pass and a `norm/bwd` span on autograd's
thread in the backward: it reads their kernels' device time a step; the
glue still counts the norm; a program without the spans reads nothing."""

import pytest

from benchmark import spans
from benchmark.tests.test_bench_spans import AUTOGRAD, _events, _inputs, _launched, _read, _span


def _with_norms():
    ev = _events()
    # a norm of 12 us launched in the teacher's pass, one of 8 us in the backward
    ev += [_span("norm/fwd", 250.0, 10.0)] + _launched(11, 255.0, 330.0, 12.0, "bn_apply_kernel")
    ev += [_span("norm/bwd", 640.0, 10.0, AUTOGRAD)]
    ev += _launched(12, 645.0, 650.0, 8.0, "bn_grad_x_kernel", AUTOGRAD)
    return ev


def test_norm_ms_reads_the_norm_spans_kernels():
    inp = _inputs(_with_norms())
    assert _read("norm_ms", inp) == pytest.approx((12.0 + 8.0) / 1e3 / 2, abs=1e-12)
    # the norm's kernels lie in the passes and outside the conv spans: glue
    assert spans.glue_us(inp["trace"]) == 25.0 + 20.0
    assert _read("norm_ms", _inputs(_events())) is None
    host_only = [e for e in _with_norms() if e["cat"] in ("user_annotation", "cuda_runtime")]
    assert _read("norm_ms", _inputs(host_only)) is None
