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
            "gcdlss_tpu_torch.tools.stage2_split", "gcdlss_tpu_torch.train.finetune",
            "gcdlss_tpu_torch.train.feature_mixing", "gcdlss_tpu_torch.train.registry",
            "gcdlss_tpu_torch.train.uncertainty", "gcdlss_tpu_torch.eval.sweep",
            "gcdlss_tpu_torch.main", "gcdlss_tpu_torch.config",
            "gcdlss_tpu_torch.train.checkpoint", "gcdlss_tpu_torch.utils.logging",
            "gcdlss_tpu_torch.utils.misc", "gcdlss_tpu_torch.utils.visualize",
            "gcdlss_tpu_torch.algo.sinkhorn", "gcdlss_tpu_torch.algo.clustering",
            "gcdlss_tpu_torch.losses_lion", "gcdlss_tpu_torch.ops.voxelize",
            "gcdlss_tpu_torch.eval.ioueval", "gcdlss_tpu_torch.eval.clustering_eval",
            "gcdlss_tpu_torch.algo.dbscan", "gcdlss_tpu_torch.train.nops",
            "gcdlss_tpu_torch.tools.discovery_quality", "gcdlss_tpu_torch.ops.asym",
            "gcdlss_tpu_torch.ops.scatter", "gcdlss_tpu_torch.ops.lovasz",
            "gcdlss_tpu_torch.models.voxelizer", "gcdlss_tpu_torch.models.cylinder3d",
            "gcdlss_tpu_torch.train.cylinder", "gcdlss_tpu_torch.models.heads",
            "gcdlss_tpu_torch.models.orca", "gcdlss_tpu_torch.models.wrappers",
            "gcdlss_tpu_torch.models.backbone_mm", "gcdlss_tpu_torch.losses_zoo",
            "gcdlss_tpu_torch.parallel.mesh", "gcdlss_tpu_torch.parallel.voxel_shard",
            "gcdlss_tpu_torch.parallel.sp_step", "gcdlss_tpu_torch.parallel.sp_discover"
            } <= set(names)
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
                                    "gcdlss_tpu_torch.tools.stage2_split",
                                    "gcdlss_tpu_torch.tools.strip_occupancy"])
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


def test_parts_ab_fails_without_cuda():
    """The A/B timer, run as the script it is, raises without a CUDA device."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "gcdlss_tpu_torch/tools/parts_ab.py"),
                           "--root", str(ROOT)], capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def test_cli_host_layer_imports_no_yaml_or_orbax():
    """The CLI, its config reader and its checkpoints bring in no JAX, no
    module of the JAX package, no YAML library and no orbax, on import and
    through a configuration file read."""
    mods = ("gcdlss_tpu_torch.main", "gcdlss_tpu_torch.config",
            "gcdlss_tpu_torch.train.checkpoint")
    banned = FORBIDDEN + ("yaml", "orbax")
    proc = _run("import importlib, sys\n"
                f"for n in {mods!r}: importlib.import_module(n)\n"
                "from gcdlss_tpu_torch.config import CONFIG_DIR, load_config\n"
                "load_config(str(CONFIG_DIR / 'semkitti_minkunet.yaml'))\n"
                f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {banned!r})\n"
                "print(bad)\nsys.exit(1 if bad else 0)\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_fails_without_cuda_unless_asked_for_the_cpu(tmp_path):
    """`python -m gcdlss_tpu_torch.main` raises without a CUDA device (its
    default `--device cuda`) and runs with `--device cpu`."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gcdlss_tpu_torch.data import write_synthetic_kitti

    write_synthetic_kitti(str(tmp_path / "kitti"), sequences=("00",), scans_per_seq=2,
                          num_points=600, seed=1)
    argv = [sys.executable, "-m", "gcdlss_tpu_torch.main", "--module", "ExpPretrain",
            "--dataset_path", str(tmp_path / "kitti"), "--voxel_size", "0.2",
            "--downsampling", "500", "--voxel_cap", "1024", "--arch", "MinkUNet14",
            "--batch_size", "1", "--num_workers", "1", "--epochs", "1",
            "--checkpoint_dir", str(tmp_path / "ck"), "--log_dir", str(tmp_path / "logs"),
            "--split_dir", str(tmp_path / "split")]
    env = {**_env(), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(argv, capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not (tmp_path / "ck").exists()
    proc = subprocess.run(argv + ["--device", "cpu"], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "epoch 0: loss=" in proc.stdout
    assert (tmp_path / "ck" / "exp" / "pretrained" / "state_dict.pt").is_file()


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
