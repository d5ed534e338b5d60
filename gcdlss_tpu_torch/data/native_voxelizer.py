"""ctypes binding for the native C++ voxelizer (`csrc/voxelizer.cpp`).

The shared library is built with the host compiler at first use into
`build/voxelizer/` under the repository root, named by a hash of the source
and the flags, so an edited source is rebuilt. Nothing falls back: `library`
raises when there is no compiler or the build fails. numpy
(`quantize_np.sparse_quantize_np`) is the default path; this one runs only
when a caller asks for it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "voxelizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "voxelizer"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_F, _I32, _I64 = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_int32, ctypes.c_int64))


def build() -> Path:
    """Compile the library unless it exists for the current source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f"libgcdlss_voxelizer-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found: the native voxelizer cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} voxelizer.cpp failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.gcdlss_sparse_quantize.restype = ctypes.c_int64
    lib.gcdlss_sparse_quantize.argtypes = [_F, ctypes.c_int64, ctypes.c_float, _I32, _I64, _I64]
    lib.gcdlss_decode_labels.restype = ctypes.c_int64
    lib.gcdlss_decode_labels.argtypes = [_I32, ctypes.c_int64, _I32, ctypes.c_int64, _I32, _I32]
    return lib


def sparse_quantize(points: np.ndarray, voxel_size: float):
    lib = library()
    n = points.shape[0]
    pts = np.ascontiguousarray(points, np.float32)
    coords = np.empty((n, 3), np.int32)
    unique = np.empty(n, np.int64)
    inverse = np.empty(n, np.int64)
    m = lib.gcdlss_sparse_quantize(
        pts.ctypes.data_as(_F), n, ctypes.c_float(voxel_size),
        coords.ctypes.data_as(_I32), unique.ctypes.data_as(_I64), inverse.ctypes.data_as(_I64))
    return coords[:m].copy(), unique[:m].copy(), inverse


def decode_labels(raw: np.ndarray, lut: np.ndarray):
    lib = library()
    n = raw.shape[0]
    raw = np.ascontiguousarray(raw, np.int32)
    lut = np.ascontiguousarray(lut, np.int32)
    sem = np.empty(n, np.int32)
    inst = np.empty(n, np.int32)
    lib.gcdlss_decode_labels(raw.ctypes.data_as(_I32), n, lut.ctypes.data_as(_I32),
                             lut.shape[0], sem.ctypes.data_as(_I32), inst.ctypes.data_as(_I32))
    return sem, inst
