"""The PyTorch port never imports JAX, and its GPU smoke refuses to run
without a CUDA device."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import gcdlss_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax():
    names = [m.name for m in pkgutil.walk_packages(gcdlss_tpu_torch.__path__,
                                                   "gcdlss_tpu_torch.")]
    assert {"gcdlss_tpu_torch.train.pretrain", "gcdlss_tpu_torch.train.discover",
            "gcdlss_tpu_torch.train.modules", "gcdlss_tpu_torch.train.lasermix",
            "gcdlss_tpu_torch.algo.kmeans", "gcdlss_tpu_torch.algo.hungarian",
            "gcdlss_tpu_torch.algo.queue"} <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'optax')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=_env(), cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_cuda():
    """Where torch has no CUDA device the smoke exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                          text=True, env=_env(), cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
