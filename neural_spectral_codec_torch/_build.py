"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started at once,
and the objects link into ONE shared library with a plain C interface,
loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <src>.o csrc/<src>.cu      (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libnsc_kernels_<hash>.so *.o

The build runs at first use and again whenever the sources or flags
change (the library name carries a hash of both), so a fresh checkout
builds everything on its first kernel call. No ``--use_fast_math``: the
projection kernels must round exactly as PyTorch's own CUDA operators do.

A failed build raises, and so does a nonzero ``cudaGetLastError()`` after
any launch: there is no fallback to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
MAX_SHARED_BYTES = 232_448        # opt-in shared memory of one H100 CTA


def sources() -> list:
    """The CUDA sources that make up the library, in a fixed order."""
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash over every source and header and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libnsc_kernels_{source_hash()}.so"


def find_nvcc() -> str:
    """``nvcc`` from the CUDA toolkit PyTorch found, else from PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("cannot build the CUDA kernels: nvcc not found "
                           "(no CUDA toolkit on this host)")
    return found


def build() -> Path:
    """Compile the library if the current sources have not been built.

    Returns its path. Raises ``RuntimeError`` with the compiler's output
    when nvcc fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources()]
        _run_nvcc([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                   for src, obj in zip(sources(), objs)], log)
        lib = str(Path(tmp) / "lib.so")
        _run_nvcc([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib, *objs]], log)
        os.replace(lib, out)   # atomic: a concurrent loader never sees half
    (BUILD_DIR / "build.log").write_text(
        f"{time.perf_counter() - t0:.3f} s\n" + "\n".join(log))
    return out


def _run_nvcc(cmds: list, log: list) -> None:
    """Run the commands in parallel and wait for all of them; raise
    ``RuntimeError`` with the output of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, output in zip(cmds, procs, outputs):
        log.append(f"{' '.join(cmd)}\n{output}")
    for cmd, proc, output in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{output}")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library (once per process)."""
    lib = ctypes.CDLL(str(build()))
    lib.nsc_error_string.argtypes = [ctypes.c_int]
    lib.nsc_error_string.restype = ctypes.c_char_p
    return lib


class CudaKernel:
    """One C entry point of the library, with its launch count.

    Every entry point returns the ``cudaError_t`` of its launch
    (``cudaGetLastError()`` right after it); a nonzero code raises.
    ``launches`` counts successful launches and nothing else.
    ``last_args`` keeps the arguments of the last call, so that ``bare``
    can launch the same work again without the wrapper (to time the
    kernel apart from it; such launches are not counted)."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.last_args: tuple = ()

    @functools.cached_property
    def _fn(self):
        lib = load_library()
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args) -> None:
        self._launch(args)
        self.last_args = args
        self.launches += 1

    def _launch(self, args: tuple) -> None:
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} ({error_string(err)})")

    def bare(self):
        """A callable that repeats the last call's launch: the C entry
        point on the same pointers, sizes and stream, with no wrapper
        around it. The tensors of that call must still be alive."""
        args = self.last_args
        return lambda: self._launch(args)


CENSUS = ("nodes", "kernels", "memcpy", "memset", "other", "project",
          "project_cooperative", "spectral", "spectral_cluster_width",
          "spectral_cluster_dim", "ring_fold", "unreadable_kernels",
          "nearest", "knn", "nearest_cluster_width", "knn_pca", "kabsch",
          "mine", "mine_draw", "gather_bwd")


def graph_census(graph_handle: int) -> dict:
    """The nodes of a captured CUDA graph (``torch.cuda.CUDAGraph(
    keep_graph=True).raw_cuda_graph()``) by kind, the projection kernel's
    nodes with their cooperative attribute, the spectral kernel's with its
    cluster width, and the ring, nearest-neighbour (with its cluster
    width), k-NN, k-NN PCA, Kabsch, mining and gather-backward kernels'
    (``nsc_graph_census`` in ``csrc/project.cu``). Raises on a CUDA
    error."""
    lib = load_library()
    fn = lib.nsc_graph_census
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(CENSUS))()
    err = fn(ctypes.c_void_p(graph_handle), out)
    if err != 0:
        raise RuntimeError(f"nsc_graph_census: CUDA error {err} "
                           f"({error_string(err)})")
    return dict(zip(CENSUS, out))


def error_string(code: int) -> str:
    """``cudaGetErrorString`` of a ``cudaError_t`` code."""
    return load_library().nsc_error_string(code).decode()


def check_contiguous(t, what: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
