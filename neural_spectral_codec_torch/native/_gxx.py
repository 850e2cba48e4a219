"""g++ build and ctypes load of the repository's host C++ libraries
(``native/nsc_geom.cpp``, ``native/nsc_io.cpp``), shared by ``geom`` and
``io``.

A :class:`NativeLibrary` compiles its source at first use,

    g++ <flags> -o neural_spectral_codec_torch/_build/<stem>_<hash>.so
        native/<source> <link flags>

and loads it once per process. The hash covers the source, the flags and
the host CPU (``-march=native`` code may not run on another CPU), so a
changed source or another machine builds anew. Nothing is written into
``native/`` and a pre-built library there is never loaded. A failed build
or load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

_PKG_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG_DIR.parent / "native"
BUILD_DIR = _PKG_DIR / "_build"
# native/Makefile's CXXFLAGS, plus -shared
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared")


def _host_cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.processor() or platform.machine()


class NativeLibrary:
    """One C++ source of ``native/`` built into ``_build/`` and bound by
    ``configure`` (which sets each entry point's ``argtypes`` and
    ``restype``)."""

    def __init__(self, stem: str, source: str, flags: Sequence[str],
                 configure: Callable[[ctypes.CDLL], None],
                 link: Sequence[str] = ()):
        self.stem = stem
        self.source = NATIVE_DIR / source
        self.flags = tuple(flags)
        self.link = tuple(link)
        self._configure = configure
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(self.flags + self.link).encode())
        h.update(self.source.read_bytes())
        h.update(_host_cpu().encode())
        return BUILD_DIR / f"{self.stem}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library unless this source, these flags and this
        CPU were built already; returns its path. Raises ``RuntimeError``
        with the compiler's output when g++ fails or is missing."""
        if not self.source.exists():
            raise RuntimeError(f"native source missing: {self.source}")
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cxx = os.environ.get("CXX", "g++")
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            lib = Path(tmp) / "lib.so"
            try:
                proc = subprocess.run(
                    [cxx, *self.flags, "-o", str(lib), str(self.source),
                     *self.link], capture_output=True, text=True,
                    timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"cannot build {self.stem}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({proc.returncode}) on {self.source}:\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(lib, out)  # atomic: a concurrent loader never sees half
        return out

    def load(self) -> ctypes.CDLL:
        """Build if needed, then load the library (once per process)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._configure(lib)
                self._lib = lib
            return self._lib

    def available(self) -> bool:
        """True when the library builds (if it has not yet) and loads."""
        try:
            self.load()
        except (RuntimeError, OSError):
            return False
        return True
