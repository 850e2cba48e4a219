"""Kernel Q: the stage-1 query's fused body. Its plain PyTorch version and
the binding of its hand-written kernel, ``csrc/query.cu``.

It is no Pallas kernel's port: the JAX package leaves this work to XLA
inside its one-dispatch query programs
(``neural_spectral_codec_tpu/retrieval/retriever.py`` ``_query_math``,
:139-159, and ``_query_batch_kernel``, :106-136, which the serving step
runs too). For (Q, n_bins) query vectors (CDFs under W₁, raw vectors
under L2; ``retriever.query_math`` makes them), the first ``size`` rows
of an (N, n_bins) database (float32 rows, or uint16 codes dequantised on
the fly) and (Q, 4) filters [x, y, z, min_d]: W₁ (or L2) against every
row, +inf for rows at or past ``size`` and for rows nearer than ``min_d``
(when ``min_d > 0``), then the k smallest in ``retriever.smallest_k``'s
order (equal distances by the lower row, +inf slots by the lowest masked
rows, NaN last) → (Q, k) int64 rows and float32 distances.

Every distance is summed in one stated order (``lane_sums``; the
kernel's header has it), which the plain version follows with
elementwise adds, so the kernel and ``query_plain`` agree bit for bit,
indices and distances. Up to ``K_MAX`` the selection is fused (two
launches: candidate lists, then a merge a query); a larger k takes the
distance entry (the masked (Q, N) distances, counted on ``DIST_KERNEL``)
and ``smallest_k``. One query runs the one-query kernel; 2-32 queries a
CTA the group kernel, whose warps hold register tiles of 8 queries × 8
rows (``kTileQ`` × ``kTileR``). A CPU tensor takes the plain version, a
CUDA tensor the kernel, or the binding raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from neural_spectral_codec_torch.ops.range_image import sqrt_f32


K_MAX = 128               # kMaxK in csrc/query.cu: the fused route's k
LANES = 32
UNIT_BYTES = 16           # one load of a lane: 4 float32 values, 8 codes
MAX_TEMP = 1 << 28        # elements of one (queries, rows, bins) temporary
                          # of the plain version (1 GiB)


@functools.lru_cache(maxsize=None)
def _kernels():
    # bound at first use: importing the package loads no kernel machinery
    from neural_spectral_codec_torch._build import CudaKernel
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    shared = [p, i, i, p, p, ll, p, p, i, i, i]
    return (CudaKernel("nsc_query_topk", shared + [i, f, i, i, i, p, p, p,
                                                   p]),
            CudaKernel("nsc_query_dist", shared + [f, i, i, i, p, p]))


class GroupCount:
    """The group regime's share of the launches (Q > 1: the group kernel,
    on the fused route or the distance entry), counted beside ``KERNEL``'s
    and ``DIST_KERNEL``'s own counts; a graph capture credits it as it
    credits them (``launches``, ``last_args``)."""

    def __init__(self):
        self.launches = 0
        self.last_args: tuple = ()


GROUP = GroupCount()


def __getattr__(name: str):
    # the two entries, each with its launch count: KERNEL the fused route
    # (both of its launches a call), DIST_KERNEL the distance entry
    if name == "KERNEL":
        return _kernels()[0]
    if name == "DIST_KERNEL":
        return _kernels()[1]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def unit_elems(dtype: torch.dtype) -> int:
    """Elements of one 16-byte unit of a row: 4 float32, 8 uint16."""
    return UNIT_BYTES // dtype.itemsize


def lane_sums(rows: torch.Tensor, q: torch.Tensor, metric: str,
              unit: int) -> torch.Tensor:
    """(N, B) float32 rows and (Qc, B) queries → (Qc, N) sums of |r − q|
    (W₁) or (r − q)² (L2) in the kernel's order: rows cut into units of
    ``unit`` elements, zero-padded to a multiple of 32 units; lane l's
    terms (units l, l + 32, ... in order, each unit's elements in order)
    added one by one from the first; then the 32 lane sums by the xor
    butterfly (halves added: lane i with lane i + 16, then i + 8, ...)."""
    n, b = rows.shape
    per_lane = -(-b // (unit * LANES))
    pad = per_lane * LANES * unit - b
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
        q = torch.nn.functional.pad(q, (0, pad))
    diff = rows[None, :, :] - q[:, None, :]
    terms = diff.abs() if metric == "wasserstein" else diff * diff
    # (Qc, N, units a lane, lane, element of a unit)
    terms = terms.view(q.shape[0], n, per_lane, LANES, unit)
    acc = terms[:, :, 0, :, 0]
    for j in range(per_lane):
        for v in range(unit):
            if j or v:
                acc = acc + terms[:, :, j, :, v]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def distances_plain(rows: torch.Tensor, q: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """(Q, N) W₁ (or L2) distances of ``q`` against the stored rows
    (uint16 codes dequantised) in the kernel's order; queries go in chunks
    that keep the (queries, rows, bins) temporary under ``MAX_TEMP``
    elements."""
    from neural_spectral_codec_torch.retrieval.retriever import (
        dequantize_rows)
    unit = unit_elems(rows.dtype)
    x = dequantize_rows(rows)
    step = max(1, MAX_TEMP // max(x.numel(), 1))
    d = torch.cat([lane_sums(x, c, metric, unit) for c in q.split(step)])
    return sqrt_f32(d) if metric == "l2" else d


def spatial_norm(pos: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """(Q, N) |pos − (x, y, z)| as the kernel computes it:
    √(((dx·dx) + (dy·dy)) + (dz·dz)), each operation rounded on its own,
    the root correctly rounded."""
    d = [pos[None, :, c] - filters[:, c, None] for c in range(3)]
    return sqrt_f32((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])


def query_plain(rows: torch.Tensor, pos: torch.Tensor, size,
                q: torch.Tensor, filters: torch.Tensor, k: int,
                metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel Q's function with torch operations: (Q, k) int64 rows and
    float32 distances (every NaN made torch's one NaN, ranked last)."""
    from neural_spectral_codec_torch.retrieval.retriever import smallest_k
    n = rows.shape[0]
    d = distances_plain(rows, q, metric)
    invalid = (torch.arange(n, device=rows.device) >= size)[None, :]
    min_d = filters[:, 3:4]
    near = (min_d > 0) & (spatial_norm(pos, filters) < min_d)
    d = torch.where(invalid | near, torch.inf, d)
    d = torch.where(torch.isnan(d), torch.nan, d)
    top_d, top_i = smallest_k(d, k)
    return top_i, top_d


@functools.lru_cache(maxsize=None)
def _layout(device_index: int, storage: int, metric: int, n: int, bins: int,
            n_queries: int, k: int) -> Tuple[int, int, int, int]:
    """(CTAs, queries a CTA, shared bytes, candidate lists a query) of a
    call (``nsc_query_layout``; host-side, so a capture's calls read it
    from this cache); k = 0: the distance entry's."""
    from neural_spectral_codec_torch._build import error_string, load_library
    fn = load_library().nsc_query_layout
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        err = fn(storage, metric, n, bins, n_queries, k, out)
    if err != 0:
        raise RuntimeError(f"nsc_query_layout: CUDA error {err} "
                           f"({error_string(err)})")
    return out[0], out[1], out[2], out[3]


@functools.lru_cache(maxsize=None)
def _scale() -> float:
    """float32(1 / 65535), the codes' scale (``retriever.dequantize_rows``)."""
    from neural_spectral_codec_torch.retrieval.retriever import CDF_QUANT
    return float(torch.tensor(1.0 / CDF_QUANT, dtype=torch.float32))


def _check(t: torch.Tensor, what: str, shape: tuple, dtypes: tuple,
           device: torch.device) -> None:
    if t.device != device or t.dtype not in dtypes or tuple(t.shape) != shape:
        raise ValueError(f"query_cuda: {what} must be {shape} "
                         f"{' or '.join(map(str, dtypes))} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"query_cuda: {what} must be contiguous")


def query_cuda(rows: torch.Tensor, pos: torch.Tensor, size, q: torch.Tensor,
               filters: torch.Tensor, k: int, metric: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel Q on the card: ``rows`` (N, B) float32 or uint16
    (W₁ only), ``pos`` (N, 3), ``q`` (Q, B) and ``filters`` (Q, 4)
    float32, all contiguous on one card; ``size`` an int or a 0-d int64
    tensor there (read by the kernel); 1 ≤ k ≤ N. k ≤ ``K_MAX``: the fused
    route (``KERNEL``); beyond, the distance entry (``DIST_KERNEL``) and
    ``smallest_k``. Scratch and outputs come from ``torch.empty`` (a
    capture's pool). Devices, types, shapes and contiguity are checked
    first (``ValueError``, nothing launched)."""
    dev = rows.device
    if metric not in ("wasserstein", "l2"):
        raise ValueError(f"query_cuda: unknown metric {metric}")
    if rows.dim() != 2 or rows.shape[0] < 1 or rows.shape[1] < 1:
        raise ValueError(f"query_cuda: rows must be (N, n_bins), got "
                         f"{tuple(rows.shape)}")
    n, bins = rows.shape
    _check(rows, "rows", (n, bins),
           (torch.float32,) if metric == "l2" else
           (torch.float32, torch.uint16), dev)
    _check(pos, "pos", (n, 3), (torch.float32,), dev)
    if q.dim() != 2 or q.shape[0] < 1:
        raise ValueError(f"query_cuda: q must be (Q, {bins}), got "
                         f"{tuple(q.shape)}")
    n_q = q.shape[0]
    _check(q, "q", (n_q, bins), (torch.float32,), dev)
    _check(filters, "filters", (n_q, 4), (torch.float32,), dev)
    if torch.is_tensor(size):
        _check(size, "size", (), (torch.int64,), dev)
        size_ptr, size_val = size.data_ptr(), 0
    else:
        size_ptr, size_val = None, int(size)
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"query_cuda: k = {k} outside 1 .. {n}")
    if dev.type != "cuda":
        raise ValueError(f"query_cuda needs CUDA tensors, got {dev}")
    from neural_spectral_codec_torch.retrieval.retriever import smallest_k
    storage = int(rows.dtype == torch.uint16)
    l2 = int(metric == "l2")
    fused = k <= K_MAX
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    ctas, group, smem, lists = _layout(index, storage, l2, n, bins, n_q,
                                       k if fused else 0)
    head = (rows.data_ptr(), storage, l2, pos.data_ptr(), size_ptr, size_val,
            q.data_ptr(), filters.data_ptr(), n, bins, n_q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fused:
            cand = torch.empty((n_q, lists, k), dtype=torch.int64,
                               device=dev)
            idx = torch.empty((n_q, k), dtype=torch.int64, device=dev)
            dist = torch.empty((n_q, k), dtype=torch.float32, device=dev)
            _kernels()[0](*head, k, _scale(), ctas, group, smem,
                          cand.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                          stream)
            if n_q > 1:
                GROUP.launches += 1
            return idx, dist
        d = torch.empty((n_q, n), dtype=torch.float32, device=dev)
        _kernels()[1](*head, _scale(), ctas, group, smem, d.data_ptr(), stream)
        if n_q > 1:
            GROUP.launches += 1
    top_d, top_i = smallest_k(d, k)
    return top_i, top_d


def query(rows: torch.Tensor, pos: torch.Tensor, size, q: torch.Tensor,
          filters: torch.Tensor, k: int, metric: str
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel Q on CUDA tensors, its plain version on CPU tensors (k = 0:
    empty answers, nothing to rank)."""
    if rows.device.type == "cpu":
        return query_plain(rows, pos, size, q, filters, k, metric)
    if k == 0:
        return (torch.empty((q.shape[0], 0), dtype=torch.int64,
                            device=rows.device),
                torch.empty((q.shape[0], 0), dtype=torch.float32,
                            device=rows.device))
    return query_cuda(rows, pos, size, q.contiguous(), filters.contiguous(),
                      k, metric)
