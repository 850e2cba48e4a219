"""Read-ahead frame iteration over the dataset loaders through the native
IO library (``native/nsc_io.cpp``, bound by ``native/io.py``). The port's
copy of ``neural_spectral_codec_tpu/data/native_io.py``.

C++ worker threads read and decode scans ahead of the consumer, so disk
IO overlaps keyframe selection and encoding. Decode is bit-identical to
the numpy loaders, and a per-file native read or size error falls back to
``loader[idx]``, so a corrupt scan behaves exactly as on the Python path
(it raises, or NCLT's loader returns an empty cloud). A library that
cannot be built raises.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np

from neural_spectral_codec_torch.data.helipr import HeLiPRLoader
from neural_spectral_codec_torch.data.kitti import KITTILoader
from neural_spectral_codec_torch.data.nclt import NCLTLoader
from neural_spectral_codec_torch.native import io as native_io
from neural_spectral_codec_torch.utils.config import get as cfg_get


def _format_and_files(loader):
    if isinstance(loader, KITTILoader):
        return native_io.FORMAT_KITTI, loader.frame_files
    if isinstance(loader, NCLTLoader):
        return native_io.FORMAT_NCLT, loader.frame_files
    if isinstance(loader, HeLiPRLoader):
        # 5-float rows: the explicit ring ids ride along for the ring path
        return native_io.FORMAT_HELIPR5, loader.scan_files
    return None, None


class FramePrefetcher:
    """Sequential frame access with native read-ahead.

    ``get(idx)`` must be called for idx = 0, 1, 2, ... from one thread
    and returns the same item dict as ``loader[idx]``. Construct via
    :meth:`create`, which returns None where the native path does not
    apply (the mode, an unknown loader type, preloaded points); callers
    then index the loader. Close when done (context manager supported).
    """

    def __init__(self, loader, prefetcher: native_io.NativePrefetcher):
        self._loader = loader
        self._native = prefetcher

    @classmethod
    def create(cls, loader, n_threads: int = 4, depth: int = 8,
               mode: str = "auto") -> Optional["FramePrefetcher"]:
        """mode: "auto" prefetches only the decode-bound formats (NCLT's
        12-byte unpack, HeLiPR's strided gather); KITTI decode is a bare
        copy, so "auto" leaves it to the loader and "always" includes it
        (cold storage); "off" disables all. Raises when the library
        cannot be built."""
        if mode == "off":
            return None
        fmt, files = _format_and_files(loader)
        if fmt is None or not getattr(loader, "lazy_load", False):
            return None
        if mode == "auto" and fmt == native_io.FORMAT_KITTI:
            return None
        return cls(loader, native_io.NativePrefetcher(
            [str(f) for f in files], fmt, n_threads=n_threads, depth=depth))

    def get(self, idx: int) -> dict:
        status, points = self._native.get(idx)
        if status != native_io.STATUS_OK:
            # the Python path's behaviour for this file (raise, or NCLT's
            # empty-cloud recovery)
            return self._loader[idx]
        if points.shape[1] == 5:  # HeLiPR5: split the ring column off
            return self._loader._assemble(
                idx, np.ascontiguousarray(points[:, :4]),
                points[:, 4].astype(np.int64))
        return self._loader._assemble(idx, points)

    def close(self) -> None:
        self._native.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def frame_source(loader, config: Optional[dict] = None):
    """Context manager yielding a ``get(idx)`` callable over ``loader``'s
    frames, read ahead natively as ``system.io_prefetch`` allows ("auto"
    by default; booleans mean "always" / "off", since an unquoted YAML
    ``off`` parses as False). The prefetcher is closed on any exit. This
    is the one place the config key is read."""
    mode = cfg_get(config or {}, "system.io_prefetch", "auto")
    if isinstance(mode, bool):
        mode = "always" if mode else "off"
    prefetcher = FramePrefetcher.create(loader, mode=mode)
    try:
        yield (loader.__getitem__ if prefetcher is None
               else prefetcher.get)
    finally:
        if prefetcher is not None:
            prefetcher.close()
