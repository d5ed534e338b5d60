"""The PyTorch port never imports JAX nor anything of the JAX package, and
its GPU entry points refuse to run without a CUDA device."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import gcdlss_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


# what no module of the port may bring in: JAX and its libraries, the JAX
# package, and the JAX package's bench script
FORBIDDEN = ("jax", "flax", "optax", "gcdlss_tpu", "bench")
REPORT_FORBIDDEN = (
    f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
    "print(bad)\n"
    "sys.exit(1 if bad else 0)\n")


def _run(code: str):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=_env(), cwd=ROOT, timeout=120)


def test_port_imports_no_jax():
    names = [m.name for m in pkgutil.walk_packages(gcdlss_tpu_torch.__path__,
                                                   "gcdlss_tpu_torch.")]
    assert {"gcdlss_tpu_torch.train.pretrain", "gcdlss_tpu_torch.train.discover",
            "gcdlss_tpu_torch.train.modules", "gcdlss_tpu_torch.train.lasermix",
            "gcdlss_tpu_torch.algo.kmeans", "gcdlss_tpu_torch.algo.hungarian",
            "gcdlss_tpu_torch.algo.queue", "gcdlss_tpu_torch.data.loader",
            "gcdlss_tpu_torch.data.semantic_kitti", "gcdlss_tpu_torch.data.nuscenes",
            "gcdlss_tpu_torch.data.native_voxelizer", "gcdlss_tpu_torch.utils.weights",
            "gcdlss_tpu_torch.ops.conv_parts", "gcdlss_tpu_torch.tools.conv_parts",
            "gcdlss_tpu_torch.tools.stage2_split"} <= set(names)
    proc = _run("import importlib, sys\n"
                f"for n in {names!r}: importlib.import_module(n)\n" + REPORT_FORBIDDEN)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_module_imports_no_jax():
    """`chip_smoke` imported as a module (its `main` not run)."""
    proc = _run("import sys\nimport chip_smoke\n" + REPORT_FORBIDDEN)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_forbidden_modules_are_seen():
    """The check itself: a process that did import the JAX package's data
    modules (numpy only) is reported."""
    proc = _run("import sys\nimport gcdlss_tpu.data.quantize_np\n" + REPORT_FORBIDDEN)
    assert proc.returncode == 1 and "gcdlss_tpu.data.quantize_np" in proc.stdout, proc.stdout


IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")(?![\w])", re.MULTILINE)


def test_port_sources_name_no_jax_package():
    """No `import gcdlss_tpu` / `from gcdlss_tpu...` / `from bench` / `import
    jax` in any source of the port or in `chip_smoke.py`, inside functions
    included (`gcdlss_tpu_torch` itself is another name and does not match)."""
    sources = sorted(Path(gcdlss_tpu_torch.__path__[0]).rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 40
    bad = [(str(p.relative_to(ROOT)), m.group(0).strip())
           for p in sources for m in IMPORT_RE.finditer(p.read_text())]
    assert not bad, bad
    assert IMPORT_RE.search("    from gcdlss_tpu.data import PrefetchLoader")
    assert IMPORT_RE.search("from bench import synth_scan_points")
    assert not IMPORT_RE.search("from gcdlss_tpu_torch.data import PrefetchLoader")


@pytest.mark.parametrize("module", ["gcdlss_tpu_torch.tools.conv_parts",
                                    "gcdlss_tpu_torch.tools.stage2_split"])
def test_tools_fail_without_cuda(module):
    """An entry point of the port raises without a CUDA device unless it was
    asked for the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "-m", module], capture_output=True, text=True,
                          env=_env(), cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def test_chip_smoke_fails_without_cuda():
    """Where torch has no CUDA device the smoke exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                          text=True, env=_env(), cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
