"""Device-resident W₁ retrieval database.

Port of ``neural_spectral_codec_tpu/retrieval/retriever.py``
(``WassersteinRetriever``). A preallocated (capacity, n_bins) row buffer
and (capacity, 3) position buffer live on the device and are updated in
place. A query is W₁ (or L2) against every row, a mask that sends rows ≥
the effective size and rows spatially nearer than ``min_d`` (when
``min_d > 0``) to +inf, then an exact smallest-k in ``lax.top_k``'s
order (``smallest_k``).

``storage="uint16"`` keeps each CDF row as ``round(cdf · 65535)`` codes
(W₁ only: half the device memory, a W₁ error of at most
n_bins · 0.5/65535, about 6e-3 at 800 bins) and dequantises them inside
the query. A re-entrant lock orders size bookkeeping, inserts and queries
between threads (the online loop's background worker queries while the
main thread inserts).

``query`` and ``query_batch`` run one static step a (Q, k) shape,
``QueryExecutable`` (JAX's one-dispatch ``_query_kernel`` and
``_query_batch_kernel``,
``neural_spectral_codec_tpu/retrieval/retriever.py:106-181``): the
queries, filters and effective size staged with one upload,
``query_math``, the indices and distances fetched with one download. On
a card the step is captured into a CUDA graph at its first run and
replayed; every query graph of a device shares one memory pool and runs
on that pool's stream under its lock, which a query holds, with the
retriever's lock, from the staging to the fetch, so a query sees exactly
the rows below its effective size and no two query graphs run at once.
``rank`` is the traceable body itself (JAX ``_query_math``), which the
serving step captures inside its own graph.
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.ops.wasserstein import histogram_cdf
from neural_spectral_codec_torch.utils.graph_exec import (
    Arena, ExecutableCache, GraphStep, SharedPool)


_MAX_TEMP = 1 << 28   # elements of one (queries, rows, n_bins) temporary
CDF_QUANT = 65535.0


def quantize_cdf(cdf: torch.Tensor) -> torch.Tensor:
    """CDF rows in [0, 1] → uint16 codes ``round(cdf · 65535)`` (JAX
    ``_quantize_cdf``, retriever.py:51)."""
    return torch.round(cdf * CDF_QUANT).to(torch.int32).to(
        torch.int16).view(torch.uint16)


@functools.lru_cache(maxsize=None)
def _dequant_scale(device: torch.device) -> torch.Tensor:
    # one float32(1/65535) per device: made once, never copied per query
    # (a copy from the host could not be captured into a CUDA graph)
    return torch.tensor(1.0 / CDF_QUANT, dtype=torch.float32, device=device)


def dequantize_rows(rows: torch.Tensor) -> torch.Tensor:
    """uint16 codes → float32 ``code · float32(1/65535)`` (JAX
    ``_dequant_rows``, retriever.py:55); float32 rows pass through. The
    codes are read through an int16 view, which every torch operator
    takes."""
    if rows.dtype != torch.uint16:
        return rows
    codes = (rows.view(torch.int16).to(torch.int32) & 0xFFFF).to(
        torch.float32)
    return codes * _dequant_scale(rows.device)


def smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of float32 ``d``, ascending,
    equal values by the lower index first: the order of JAX's
    ``lax.top_k`` on ``-d`` (``torch.topk`` leaves ties unordered). Each
    entry becomes one int64 key, its float32 bits mapped to a signed
    integer of the same total order (-0 before +0) in the high word and
    its column in the low word, so the keys are distinct."""
    bits = d.contiguous().view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    col = torch.arange(d.shape[-1], device=d.device, dtype=torch.int64)
    keys = torch.topk(keys.bitwise_left_shift_(32).bitwise_or_(col), k,
                      dim=-1, largest=False).values
    idx = keys & 0xFFFFFFFF
    return d.gather(-1, idx), idx


def _distances(db_rows: torch.Tensor, queries: torch.Tensor, metric: str,
               epsilon: float) -> torch.Tensor:
    """(Q, n_bins) queries vs (N, n_bins) rows → (Q, N) distances. The
    broadcast difference is materialised, so queries go in chunks that
    keep it under ``_MAX_TEMP`` elements (1 GiB)."""
    if metric == "wasserstein":
        queries = histogram_cdf(queries, epsilon)
    step = max(1, _MAX_TEMP // max(db_rows.numel(), 1))
    out = []
    for q in queries.split(step):
        diff = db_rows[None, :, :] - q[:, None, :]
        out.append(diff.abs().sum(dim=2) if metric == "wasserstein"
                   else torch.linalg.vector_norm(diff, dim=2))
    return torch.cat(out)


def query_math(db_rows: torch.Tensor, db_pos: torch.Tensor, size,
               queries: torch.Tensor, query_pos_and_filters: torch.Tensor,
               top_k: int, metric: str = "wasserstein",
               epsilon: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ranking (JAX ``_query_math`` / ``_query_batch_kernel``,
    retriever.py:107-159) for (Q, n_bins) queries and (Q, 4)
    [x, y, z, min_d] filters → (Q, k) indices and distances, smallest
    first, equal distances by the lower row as ``lax.top_k`` orders them;
    masked rows carry +inf. uint16 rows are dequantised here. ``size`` is
    an int or a 0-d int64 tensor on the rows' device (the serving step's
    device scalar)."""
    n = db_rows.shape[0]
    dists = _distances(dequantize_rows(db_rows), queries, metric, epsilon)
    invalid = (torch.arange(n, device=db_rows.device) >= size)[None, :]
    qp = query_pos_and_filters[:, :3]
    min_d = query_pos_and_filters[:, 3:4]
    spatial = torch.linalg.vector_norm(
        db_pos[None, :, :] - qp[:, None, :], dim=2) < min_d
    masked = torch.where(invalid | ((min_d > 0) & spatial), torch.inf, dists)
    top_dist, top_idx = smallest_k(masked, top_k)
    return top_idx, top_dist


POOL = SharedPool()     # every query graph of a device: one memory pool
# sharded: queries of a row-sharded retriever over distinct cards, op by op
STATS = {"captures": 0, "replays": 0, "eager_steps": 0, "sharded": 0}
_CACHE = ExecutableCache()


class QueryExecutable(GraphStep):
    """The stage-1 query at one (Q, k) against one retriever's buffers:
    (Q, n_bins) float32 queries, (Q, 4) filters and the effective size (a
    0-d int64) in, (Q, k) int64 indices and float32 distances out
    (``utils/graph_exec.GraphStep``). The step is the retriever's
    ``rank`` (a ``parallel.ShardedWassersteinRetriever``'s runs over its
    row slabs). It reads the rows, positions, their int16 view and
    ``_dequant_scale`` by address: a replaced buffer (``clear_database``)
    gets another executable (``query_executable``)."""

    def __init__(self, retriever: "WassersteinRetriever", n_queries: int,
                 top_k: int, use_graph: bool = True):
        super().__init__(retriever.device, use_graph, POOL, STATS)
        self._retriever = weakref.ref(retriever)
        self.n_queries, self.top_k = n_queries, top_k
        f32 = torch.float32
        self.inputs = Arena([("queries", (n_queries, retriever.n_bins), f32),
                             ("filters", (n_queries, 4), f32),
                             ("size", (), torch.int64)], self.device)
        self.outputs = Arena([("idx", (n_queries, top_k), torch.int64),
                              ("dist", (n_queries, top_k), f32)],
                             self.device)

    def _step(self) -> None:
        ret = self._retriever()
        i, o = self.inputs.dev, self.outputs.dev
        with torch.no_grad():
            idx, dist = ret.rank(i["queries"], i["filters"], self.top_k,
                                 i["size"])
            o["idx"].copy_(idx)
            o["dist"].copy_(dist)


def query_executable(retriever: "WassersteinRetriever", n_queries: int,
                     top_k: int, use_graph: bool = True) -> QueryExecutable:
    """The cached query step of (device, Q, k, metric, storage, ε,
    capacity, n_bins, buffer addresses); made on a miss, which drops the
    entries of replaced buffers and of retrievers that no longer exist."""
    graphed = use_graph and retriever.device.type == "cuda"
    bufs = retriever.buffer_key()
    return _CACHE.get(
        (str(retriever.device), int(n_queries), int(top_k), bufs, graphed),
        lambda: QueryExecutable(retriever, n_queries, top_k, use_graph),
        (retriever,), (retriever, bufs))


def cached_executables() -> list:
    """The query executables in the cache, oldest first."""
    return _CACHE.values()


class WassersteinRetriever:
    """Append-only descriptor database with device-side top-k queries.

    ``metric="wasserstein"`` stores normalised-histogram CDFs and ranks by
    1-D W₁; ``metric="l2"`` stores raw vectors (e.g. GNN embeddings) and
    ranks by L2. ``storage="uint16"`` (W₁ only) stores the CDFs as
    fixed-point codes. ``use_graph`` False runs the query step eagerly
    on a card (the comparison path); a CPU retriever always does."""

    def __init__(self, n_bins: int = 800, capacity: int = 100_000,
                 epsilon: float = 1e-8, metric: str = "wasserstein",
                 storage: str = "float32", device: DeviceLike = "cuda",
                 use_graph: bool = True):
        if metric not in ("wasserstein", "l2"):
            raise ValueError(f"unknown metric: {metric}")
        if storage not in ("float32", "uint16"):
            raise ValueError(f"unknown storage: {storage}")
        if storage == "uint16" and metric != "wasserstein":
            raise ValueError(
                "uint16 storage quantizes CDFs in [0, 1]; the l2 metric "
                "stores unbounded raw vectors: use storage='float32'")
        self.n_bins = n_bins
        self.capacity = capacity
        self.epsilon = epsilon
        self.metric = metric
        self.storage = storage
        self.device = resolve_device(device)
        self._row_dtype = (torch.uint16 if storage == "uint16"
                           else torch.float32)
        self.use_graph = use_graph
        self.captures = 0          # query graphs this retriever captured
        self._buffer_lock = threading.RLock()
        self.database_size = 0
        self._allocate()

    def buffer_key(self) -> tuple:
        """What a step that reads the database by address is specialised
        on: identity, metric, storage, ε and the buffers' addresses,
        shape and dtype."""
        rows, pos = self._db_rows, self._db_pos
        return (id(self), self.metric, self.storage, self.epsilon,
                rows.data_ptr(), pos.data_ptr(), tuple(rows.shape),
                rows.dtype)

    def _allocate(self) -> None:
        self._db_rows = torch.zeros((self.capacity, self.n_bins),
                                    dtype=self._row_dtype, device=self.device)
        self._db_pos = torch.zeros((self.capacity, 3), dtype=torch.float32,
                                   device=self.device)

    def _as_tensor(self, a, width: int) -> torch.Tensor:
        if isinstance(a, np.ndarray):       # views with negative strides
            a = np.ascontiguousarray(a)
        t = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        return t.reshape(-1, width)

    def encode_rows(self, vectors: torch.Tensor) -> torch.Tensor:
        """Histogram rows → stored rows (CDFs, or their uint16 codes, under
        W₁; raw vectors under L2)."""
        if self.metric == "wasserstein":
            cdf = histogram_cdf(vectors, self.epsilon)
            return quantize_cdf(cdf) if self.storage == "uint16" else cdf
        return vectors

    def write_rows(self, start, rows: torch.Tensor,
                   positions: Optional[torch.Tensor] = None) -> None:
        """Write encoded rows (and positions) at ``start`` in place; no
        size bookkeeping. ``start`` is an int or a 0-d int64 tensor on the
        device (the serving step's ``insert_at``: an ``index_copy_`` at a
        device index, so no value crosses to the host). uint16 codes go
        through an int16 view."""
        db = self._db_rows
        if rows.dtype == torch.uint16:
            db, rows = db.view(torch.int16), rows.view(torch.int16)
        if torch.is_tensor(start):
            idx = start.reshape(1) + torch.arange(
                rows.shape[0], dtype=torch.int64, device=start.device)
            db.index_copy_(0, idx, rows)
            if positions is not None:
                self._db_pos.index_copy_(0, idx, positions)
            return
        sl = slice(start, start + rows.shape[0])
        db[sl] = rows
        if positions is not None:
            self._db_pos[sl] = positions

    def add_to_database(self, histograms, positions=None) -> None:
        """Insert (n, n_bins) vectors (numpy or tensors) in place, with
        optional (n, 3) positions for spatial filtering."""
        h = self._as_tensor(histograms, self.n_bins)
        pos = None if positions is None else self._as_tensor(positions, 3)
        n = h.shape[0]
        with self._buffer_lock:
            if self.database_size + n > self.capacity:
                raise ValueError(f"Database capacity exceeded: "
                                 f"{self.database_size}+{n} > {self.capacity}")
            self.write_rows(self.database_size, self.encode_rows(h), pos)
            self.database_size += n

    def update_rows(self, indices, vectors) -> None:
        """Overwrite existing rows in place (the GNN refreshed the
        embeddings of keyframes already inserted)."""
        idx = np.atleast_1d(np.asarray(indices, np.int64))
        if len(idx) == 0:
            return
        rows = self.encode_rows(self._as_tensor(vectors, self.n_bins))
        with self._buffer_lock:
            if idx.max() >= self.database_size:
                raise IndexError("update_rows beyond database size")
            t = torch.from_numpy(idx).to(self.device)
            if rows.dtype == torch.uint16:
                self._db_rows.view(torch.int16)[t] = rows.view(torch.int16)
            else:
                self._db_rows[t] = rows

    def fused_dispatch(self, dispatch: Callable, insert: bool = True,
                       exclude_last: int = 0, writes_row: bool = True):
        """Run a serving step that owns the database for its duration.

        ``dispatch(insert_at, eff_size)`` gets the next free row and the
        effective size ``size − exclude_last`` and returns whatever the
        caller needs; it writes the new row itself (``write_rows``) and
        the buffers are updated in place, so nothing is left dangling when
        it raises. The serving executable (``models/serving.py``) stages
        the two numbers with its other inputs, so its step reads them as
        device scalars, as JAX's step gets ``jnp.int32`` scalars. Under
        the lock; ``database_size`` grows by one only when ``insert`` and
        ``dispatch`` returned. A step that ``writes_row`` without
        ``insert`` (a warm-up's scratch execution) writes the next free
        row without claiming it, so at a full database, where there is
        none, it is refused (JAX ``fused_dispatch``, retriever.py:259)."""
        with self._buffer_lock:
            if insert and self.database_size >= self.capacity:
                raise ValueError("Database capacity exceeded: "
                                 f"{self.database_size}+1 > {self.capacity}")
            if writes_row and not insert \
                    and self.database_size >= self.capacity:
                raise ValueError(
                    "fused_dispatch(insert=False) needs a free scratch "
                    "row; database is at capacity")
            insert_at = self.database_size
            eff = max(self.database_size - max(exclude_last, 0), 0)
            out = dispatch(insert_at, eff)
            if insert:
                self.database_size += 1
            return out

    def effective_size(self, exclude_last: int = 0,
                       as_of_size: Optional[int] = None) -> int:
        size0 = self.database_size if as_of_size is None else \
            min(int(as_of_size), self.database_size)
        return max(size0 - max(exclude_last, 0), 0)

    def rank(self, queries: torch.Tensor, filters: torch.Tensor, top_k: int,
             eff_size) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-side ranking of (Q, n_bins) queries with (Q, 4) filters
        against the first ``eff_size`` rows (an int or a 0-d device
        tensor) → (Q, k) tensors; k is clamped by capacity, and slots past
        the valid rows carry +inf. The traceable body (JAX
        ``_query_math``) that the serving step and ``QueryExecutable``
        run."""
        with self._buffer_lock:
            return query_math(self._db_rows, self._db_pos, eff_size, queries,
                              filters, int(min(top_k, self.capacity)),
                              self.metric, self.epsilon)

    def _ranked(self, queries, filters: np.ndarray, top_k: int,
                eff_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, n_bins) queries (host rows or a tensor on the device) and
        (Q, 4) host filters through the query step of their shape →
        (Q, k) host indices and distances. The caller holds the lock."""
        exe = query_executable(self, queries.shape[0],
                               int(min(top_k, self.capacity)), self.use_graph)
        out, captured = exe.run({"queries": queries, "filters": filters,
                                 "size": np.int64(eff_size)})
        self.captures += captured
        return out["idx"], out["dist"]

    def _query_rows(self, a):
        """Query vectors as (Q, n_bins) float32 host rows, or a tensor on
        the device as it is."""
        if torch.is_tensor(a) and a.device.type != "cpu":
            return a.reshape(-1, self.n_bins)
        if torch.is_tensor(a):
            a = a.numpy()
        return np.asarray(a, np.float32).reshape(-1, self.n_bins)

    @staticmethod
    def _filters(q: int, positions, spatial_min_distance: float
                 ) -> np.ndarray:
        qp = np.zeros((q, 4), np.float32)
        if positions is not None and spatial_min_distance > 0:
            qp[:, :3] = np.asarray(positions, np.float32).reshape(-1, 3)
            qp[:, 3] = spatial_min_distance
        return qp

    def query(self, query_hist, top_k: int = 10,
              query_position: Optional[np.ndarray] = None,
              spatial_min_distance: float = 0.0, exclude_last: int = 0,
              as_of_size: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k matches of one query → (indices, distances) as numpy,
        trimmed to finite entries. ``as_of_size`` queries the snapshot of
        that size (``exclude_last`` counts back from it)."""
        q = self._query_rows(query_hist)
        filters = self._filters(1, query_position, spatial_min_distance)
        with self._buffer_lock:
            eff = self.effective_size(exclude_last, as_of_size)
            if eff == 0:
                return np.array([], np.int64), np.array([])
            idx, dist = self._ranked(q, filters, top_k, eff)
        idx, dist = idx[0], dist[0]
        keep = np.isfinite(dist)
        return idx[keep], dist[keep]

    def query_batch(self, query_hists, top_k: int = 10,
                    query_positions: Optional[np.ndarray] = None,
                    spatial_min_distance: float = 0.0, exclude_last: int = 0,
                    as_of_size: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, n_bins) queries → (Q, k) indices and distances as numpy;
        excluded or empty slots carry distance inf and index −1."""
        q = self._query_rows(query_hists)
        filters = self._filters(q.shape[0], query_positions,
                                spatial_min_distance)
        with self._buffer_lock:
            eff = self.effective_size(exclude_last, as_of_size)
            if eff == 0:
                return (np.zeros((q.shape[0], 0), np.int64),
                        np.zeros((q.shape[0], 0)))
            idx, dist = self._ranked(q, filters, top_k, eff)
        return np.where(np.isfinite(dist), idx, -1), dist

    def warm_query(self, top_k: int) -> None:
        """Build (on a card: capture) the query step at Q = 1, which
        ``query`` runs and which is also the batched step JAX warms (its
        ``_query_batch_kernel`` at one query), by one run against the live
        buffers with the effective size forced to 1; the result is
        discarded and nothing is inserted."""
        q = np.full((1, self.n_bins), 1.0 / self.n_bins, np.float32)
        qp = np.array([[0.0, 0.0, 0.0, 1.0]], np.float32)
        with self._buffer_lock:
            self._ranked(q, qp, top_k, 1)

    def clear_database(self) -> None:
        with self._buffer_lock:
            self.database_size = 0
            self._allocate()
