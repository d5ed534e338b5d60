"""Observability: metric logging, profiler traces and the port's named spans
(PyTorch port of `gcdlss_tpu/utils/logging.py`).

`MetricsLogger` writes JSONL always and TensorBoard event files when
`torch.utils.tensorboard` imports; `profile_trace` captures a
`torch.profiler` trace into a directory; `span` names a stretch of host work
in such a trace. A step's own time is `train.common.StepClock`'s.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import record_function


class MetricsLogger:
    """JSONL (always) + TensorBoard (if available) scalar logger."""

    def __init__(self, log_dir: str, name: str = "exp"):
        self.dir = os.path.join(log_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(self.dir)
        except Exception:  # no tensorboard package: JSONL alone
            pass
        self._epoch_buf = defaultdict(list)

    def log(self, tag: str, value, step: int, on_epoch: bool = False):
        v = float(value.detach().cpu() if isinstance(value, torch.Tensor) else np.asarray(value))
        self._jsonl.write(json.dumps({"tag": tag, "value": v, "step": step}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, v, step)
        if on_epoch:
            self._epoch_buf[tag].append(v)

    def log_dict(self, metrics: dict, step: int, prefix: str = "", on_epoch: bool = False):
        for k, v in metrics.items():
            self.log(prefix + k, v, step, on_epoch)

    def epoch_end(self, epoch: int):
        for tag, vals in self._epoch_buf.items():
            self.log(tag + "_epoch", float(np.mean(vals)), epoch)
        self._epoch_buf.clear()
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: str, name: str = "trace.json"):
    """Capture a `torch.profiler` trace (host and, where there is one, CUDA
    activity) of the block; written as a Chrome trace to `log_dir/name`.
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, name))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The port's one way to name a stretch of host work: while a
    `torch.profiler` records, `record_function(name)`, which the trace puts on
    the clock of the device's events (a kernel belongs to the span its launch
    falls in); otherwise one shared null context, so that an untraced step
    reads a flag and enters no `RecordFunction`. A span times nothing itself:
    it neither waits for the device nor reads a tensor."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN
