"""Observability: metric logging, per-step timing, profiler traces
(PyTorch port of `gcdlss_tpu/utils/logging.py`).

`MetricsLogger` writes JSONL always and TensorBoard event files when
`torch.utils.tensorboard` imports; `StepTimer` times steps by CUDA events on
the card (device time, not the host clock) and by the host clock on the CPU;
`profile_trace` captures a `torch.profiler` trace into a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch


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


class StepTimer:
    """Step timing with a warm-up skip. On a CUDA device the time of a step is
    the device time between two events recorded on the current stream
    (`stop` waits for the second); elsewhere the host clock. Seconds."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.on_card = device is not None and torch.device(device).type == "cuda"
        self.times: list = []
        self._t0 = None
        self._n = 0

    def start(self):
        if self.on_card:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.on_card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._t0.elapsed_time(end) * 1e-3
        else:
            dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self):
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def p50(self):
        return float(np.median(self.times)) if self.times else float("nan")


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
