"""ctypes bindings of the native geometry library (``native/nsc_geom.cpp``).

The port's own copy of the geometry half of
``neural_spectral_codec_tpu/native/__init__.py``. ``load()`` builds the
library at first use with the flags of ``native/Makefile``

    g++ -O3 -march=native -std=c++17 -fPIC -Wall -shared
        -o neural_spectral_codec_torch/_build/libnsc_geom_<hash>.so
        native/nsc_geom.cpp

and loads it once per process. The hash covers the source, the flags and
the host CPU (``-march=native`` code may not run on another CPU), so a
changed source or another machine builds anew. Nothing is written into
``native/``. A failed build or load raises: there is no fallback here;
callers choose the plain PyTorch backend explicitly.

Entry points (all on host numpy float32 arrays; ctypes releases the GIL,
so verification threads run in parallel): ``voxel_downsample``,
``estimate_normals``, ``estimate_covariances``, ``icp``, ``gicp``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR.parent / "native" / "nsc_geom.cpp"
BUILD_DIR = _PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared")

_f32p = ctypes.POINTER(ctypes.c_float)
_lock = threading.Lock()


def _host_cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.processor() or platform.machine()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"libnsc_geom_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source, these flags and this CPU
    were built already; returns its path. Raises ``RuntimeError`` with the
    compiler's output when g++ fails or is missing."""
    out = library_path()
    if out.exists():
        return out
    if not SOURCE.exists():
        raise RuntimeError(f"native geometry source missing: {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / "lib.so"
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(lib),
                                   str(SOURCE)], capture_output=True,
                                  text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot build the geometry library: {e}")
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(lib, out)   # atomic: a concurrent loader never sees half
    return out


def _configure(lib: ctypes.CDLL) -> None:
    lib.nsc_voxel_downsample.restype = ctypes.c_int
    lib.nsc_voxel_downsample.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_float, _f32p, ctypes.c_int]
    lib.nsc_estimate_normals.restype = None
    lib.nsc_estimate_normals.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, _f32p]
    lib.nsc_estimate_covariances.restype = None
    lib.nsc_estimate_covariances.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, _f32p]
    lib.nsc_icp.restype = None
    lib.nsc_icp.argtypes = [
        _f32p, ctypes.c_int, _f32p, ctypes.c_int, _f32p, _f32p,
        ctypes.c_int, ctypes.c_float, _f32p, _f32p, _f32p]
    lib.nsc_gicp.restype = None
    lib.nsc_gicp.argtypes = [
        _f32p, ctypes.c_int, _f32p, _f32p, ctypes.c_int, _f32p,
        _f32p, ctypes.c_int, ctypes.c_float, _f32p, _f32p, _f32p]


@functools.lru_cache(maxsize=None)
def _load_cached() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    _configure(lib)
    return lib


def load() -> ctypes.CDLL:
    """Build if needed, then load the library (once per process)."""
    with _lock:
        return _load_cached()


def _c3(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)[:, :3], dtype=np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Mean of the finite points of each voxel."""
    pts = _c3(points)
    out = np.empty_like(pts)
    m = load().nsc_voxel_downsample(_ptr(pts), len(pts), voxel, _ptr(out),
                                    len(out))
    return out[:m].copy()


def estimate_normals(points: np.ndarray, k: int = 16,
                     grid_cell: float = 0.6) -> np.ndarray:
    pts = _c3(points)
    out = np.empty_like(pts)
    load().nsc_estimate_normals(_ptr(pts), len(pts), k, grid_cell, _ptr(out))
    return out


def estimate_covariances(points: np.ndarray, k: int = 20,
                         grid_cell: float = 0.6,
                         eps: float = 1e-3) -> np.ndarray:
    """GICP disk-regularised per-point covariances, (n, 3, 3)."""
    pts = _c3(points)
    out = np.empty((len(pts), 3, 3), np.float32)
    load().nsc_estimate_covariances(_ptr(pts), len(pts), k, grid_cell, eps,
                                    _ptr(out))
    return out


def icp(src: np.ndarray, dst: np.ndarray,
        normals: Optional[np.ndarray] = None,
        init: Optional[np.ndarray] = None, max_iterations: int = 30,
        max_correspondence: float = 1.0
        ) -> Tuple[np.ndarray, float, float]:
    """Point-to-point ICP, point-to-plane with ``normals``; returns
    (T (4,4), fitness, inlier_rmse)."""
    s, d = _c3(src), _c3(dst)
    nrm = (np.ascontiguousarray(normals, np.float32)
           if normals is not None else None)
    T0 = np.ascontiguousarray(
        init if init is not None else np.eye(4), np.float32)
    T_out = np.empty(16, np.float32)
    fit, rmse = ctypes.c_float(), ctypes.c_float()
    load().nsc_icp(_ptr(s), len(s), _ptr(d), len(d),
                   _ptr(nrm) if nrm is not None else None,
                   _ptr(T0), max_iterations, max_correspondence,
                   _ptr(T_out), ctypes.byref(fit), ctypes.byref(rmse))
    return T_out.reshape(4, 4).astype(np.float64), fit.value, rmse.value


def gicp(src: np.ndarray, dst: np.ndarray, cov_src: np.ndarray,
         cov_dst: np.ndarray, init: Optional[np.ndarray] = None,
         max_iterations: int = 30, max_correspondence: float = 1.0
         ) -> Tuple[np.ndarray, float, float]:
    """Generalized ICP (covariance-weighted Gauss-Newton); returns
    (T (4,4), fitness, inlier_rmse) with :func:`icp`'s inlier
    statistics."""
    s, d = _c3(src), _c3(dst)
    cs = np.ascontiguousarray(cov_src, np.float32)
    cd = np.ascontiguousarray(cov_dst, np.float32)
    T0 = np.ascontiguousarray(
        init if init is not None else np.eye(4), np.float32)
    T_out = np.empty(16, np.float32)
    fit, rmse = ctypes.c_float(), ctypes.c_float()
    load().nsc_gicp(_ptr(s), len(s), _ptr(cs), _ptr(d), len(d), _ptr(cd),
                    _ptr(T0), max_iterations, max_correspondence,
                    _ptr(T_out), ctypes.byref(fit), ctypes.byref(rmse))
    return T_out.reshape(4, 4).astype(np.float64), fit.value, rmse.value
