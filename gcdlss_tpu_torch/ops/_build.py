"""Build the CUDA kernels of `gcdlss_tpu_torch/csrc/` and load them with ctypes.

Each `csrc/*.cu` file compiles in its own `nvcc` process, all started
together, and one more `nvcc` call links the objects into one shared library
with a plain C interface, `build/kernels/libgcdlss_kernels-<hash>.so` under
the repository root. The hash covers the sources and the flags, so an edited
source, or a deleted library, is rebuilt at the next first use; nothing falls
back when the build fails. A C entry takes its pointers and the CUDA stream as
`c_void_p` and returns `cudaGetLastError()`; `check` turns a non-zero code
into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "gcd_gather_gemm": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "gcd_gather_dw": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "gcd_cube_map": (_P, _P, _I, _I, _P),
    "gcd_cube_cand": (_P, _P, _P, _P, _P, _I, _I, _P),
    "gcd_window_sum": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "gcd_gather_sum": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "gcd_tile_gemm": (_P, _P, _P, _I, _I, _I, _I, _P),
    "gcd_onehot_conv": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgcdlss_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists for the current sources."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name} failed ({proc.returncode}):\n{err}")
    if not errors:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            errors.append(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if errors:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(errors))
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
