"""ctypes bindings of the native IO library (``native/nsc_io.cpp``).

The port's own copy of ``neural_spectral_codec_tpu/native/io.py``: record
decode and threaded in-order file read-ahead for the three dataset
formats (KITTI, NCLT 12-byte, HeLiPR 22-byte). ``load()`` builds the
library at first use with the flags of ``native/Makefile``'s
``libnsc_io.so`` rule

    g++ -O3 -march=native -std=c++17 -fPIC -Wall -shared -ffp-contract=off
        -o neural_spectral_codec_torch/_build/libnsc_io_<hash>.so
        native/nsc_io.cpp -lpthread

(``native/_gxx.py``). ``-ffp-contract=off`` keeps NCLT's
``raw * 0.005 - 100`` two roundings, as numpy does; an FMA would differ in
the last ulp. Decode is bit-identical to the port's numpy loaders in
``data/``. A failed build raises: no path carries on without the library.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from neural_spectral_codec_torch.native._gxx import CXX_FLAGS, NativeLibrary

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)

FORMAT_KITTI = 0
FORMAT_NCLT = 1
FORMAT_HELIPR = 2
FORMAT_HELIPR5 = 3  # 5-float rows [x, y, z, i, ring]

STATUS_OK = 0
STATUS_READ_ERROR = 1
STATUS_BAD_SIZE = 2


def row_floats(format_id: int) -> int:
    return 5 if format_id == FORMAT_HELIPR5 else 4


def _configure(lib: ctypes.CDLL) -> None:
    lib.nsc_decode.restype = ctypes.c_int64
    lib.nsc_decode.argtypes = [
        ctypes.c_int, _u8p, ctypes.c_int64, _f32p, ctypes.c_int64]
    lib.nsc_prefetch_create.restype = ctypes.c_void_p
    lib.nsc_prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.nsc_prefetch_peek.restype = ctypes.c_int
    lib.nsc_prefetch_peek.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _i64p]
    lib.nsc_prefetch_take.restype = ctypes.c_int
    lib.nsc_prefetch_take.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _f32p]
    lib.nsc_prefetch_destroy.restype = None
    lib.nsc_prefetch_destroy.argtypes = [ctypes.c_void_p]


_LIB = NativeLibrary("libnsc_io", "nsc_io.cpp",
                     CXX_FLAGS + ("-ffp-contract=off",), _configure,
                     link=("-lpthread",))
library_path = _LIB.library_path
build = _LIB.build
load = _LIB.load


def decode(format_id: int, raw: bytes) -> np.ndarray:
    """Decode raw record bytes to an (n, row_floats) float32 array
    ([x, y, z, i], plus the ring id for FORMAT_HELIPR5).

    Raises ValueError on a format/size mismatch (as the numpy loaders'
    reshape does for a misaligned KITTI file)."""
    lib = load()
    buf = np.frombuffer(raw, dtype=np.uint8)
    cap = len(raw) // 12 + 1  # >= record count of any format
    out = np.empty((cap, row_floats(format_id)), dtype=np.float32)
    n = lib.nsc_decode(
        format_id, buf.ctypes.data_as(_u8p), len(raw),
        out.ctypes.data_as(_f32p), cap)
    if n == -2:
        raise ValueError(f"byte count {len(raw)} incompatible with format "
                         f"{format_id}")
    if n < 0:
        raise RuntimeError(f"nsc_decode capacity error ({n})")
    return out[:n].copy()


class NativePrefetcher:
    """Threaded in-order read-ahead over a list of record files.

    Items must be consumed strictly in order via :meth:`get`, from one
    consumer thread, which is also the thread that calls :meth:`close`
    (or uses the context manager). ``get`` returns ``(status, points)``;
    points is None unless status is STATUS_OK."""

    def __init__(self, paths: Sequence[str], format_id: int,
                 n_threads: int = 4, depth: int = 8):
        self._handle = None
        self._lib = load()
        self._width = row_floats(format_id)
        self._n = len(paths)
        arr = (ctypes.c_char_p * self._n)(
            *[str(p).encode() for p in paths])
        handle = self._lib.nsc_prefetch_create(
            arr, self._n, format_id, n_threads, depth)
        if not handle:
            raise ValueError(
                f"nsc_prefetch_create refused format {format_id}, "
                f"{n_threads} threads, depth {depth}")
        self._handle = handle
        self._next = 0

    def get(self, idx: int) -> Tuple[int, Optional[np.ndarray]]:
        if self._handle is None:
            raise RuntimeError("prefetcher is closed")
        if idx != self._next or idx >= self._n:
            raise RuntimeError(
                f"prefetcher items must be consumed in order: asked for "
                f"{idx}, next is {self._next} of {self._n}")
        n_points = ctypes.c_int64()
        status = self._lib.nsc_prefetch_peek(
            self._handle, idx, ctypes.byref(n_points))
        if status < 0:
            raise RuntimeError("prefetcher peek protocol violation "
                               "(closed concurrently?)")
        points = None
        if status == STATUS_OK:
            points = np.empty((n_points.value, self._width),
                              dtype=np.float32)
            rc = self._lib.nsc_prefetch_take(
                self._handle, idx,
                points.ctypes.data_as(_f32p) if n_points.value else None)
        else:
            rc = self._lib.nsc_prefetch_take(self._handle, idx, None)
        if rc != 0:
            raise RuntimeError("prefetcher take protocol violation")
        self._next += 1
        return status, points

    def close(self) -> None:
        if self._handle is not None:
            self._lib.nsc_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
