"""Row-sharded W₁ retrieval database.

Port of ``neural_spectral_codec_tpu/parallel/retrieval.py``. The
(capacity, n_bins) row buffer and the (capacity, 3) positions are cut
into one contiguous slab per mesh device (capacity rounded up to a
multiple of the mesh size). A query runs ``retriever.query_math`` on
each slab, on the slab's device: local W₁ (or L2), the validity and
spatial masks, a local top-k. Each slab's (Q, k) indices and distances go
to ``mesh.devices[0]``, shard by shard, where a global top-k picks the
answer: the candidates lie in shard-major order, and both top-k levels
order equal distances by position (``retriever.smallest_k``), so equal
distances come out by the lower global row, as the unsharded retriever
and JAX's ``lax.top_k`` order them.

JAX's query is one jitted ``shard_map`` (parallel/retrieval.py:67-72).
On a one-device mesh (``Mesh([cuda:0] * 4)``) ``query`` and
``query_batch`` run ``retriever.QueryExecutable`` with ``rank`` as its
step: the queries, filters and effective size in one upload, each slab's
local size a device clamp of that size, the (Q, k) answer in one
download; on a card one captured CUDA graph, replayed under the
retriever's lock (``warm_query`` captures it, as ``pipeline.warmup``
asks). Over distinct cards a query spans several devices' streams and
runs op by op, counted in ``retriever.STATS["sharded"]``. Inserts and
``update_rows`` are in-place copies into the slabs: nothing to capture.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.parallel.mesh import Mesh
from neural_spectral_codec_torch.retrieval import retriever as _retriever
from neural_spectral_codec_torch.retrieval.retriever import (
    WassersteinRetriever, query_math, smallest_k)


class ShardedWassersteinRetriever(WassersteinRetriever):
    """``WassersteinRetriever`` with its rows sharded over ``mesh``: the
    same insert, update and query surface (float32 or uint16 storage, W₁
    or L2), the same lock. ``device`` is ``mesh.devices[0]``, where
    inputs are encoded and answers are merged. ``use_graph`` False runs
    the query step eagerly on a card (the comparison path)."""

    def __init__(self, mesh: Mesh, n_bins: int = 800,
                 capacity: int = 100_000, epsilon: float = 1e-8,
                 metric: str = "wasserstein", storage: str = "float32",
                 use_graph: bool = True):
        self.mesh = mesh
        self.n_devices = mesh.size
        self.rows_per_shard = -(-capacity // self.n_devices)
        super().__init__(n_bins=n_bins,
                         capacity=self.rows_per_shard * self.n_devices,
                         epsilon=epsilon, metric=metric, storage=storage,
                         device=mesh.devices[0], use_graph=use_graph)

    def buffer_key(self) -> tuple:
        """The query step's specialisation: the base key's terms over
        every slab's buffers."""
        return (id(self), self.metric, self.storage, self.epsilon,
                tuple(r.data_ptr() for r in self._slab_rows),
                tuple(p.data_ptr() for p in self._slab_pos),
                self.rows_per_shard, self._row_dtype)

    def _allocate(self) -> None:
        self._slab_rows: List[torch.Tensor] = [
            torch.zeros((self.rows_per_shard, self.n_bins),
                        dtype=self._row_dtype, device=d)
            for d in self.mesh.devices]
        self._slab_pos: List[torch.Tensor] = [
            torch.zeros((self.rows_per_shard, 3), dtype=torch.float32,
                        device=d) for d in self.mesh.devices]

    def _pieces(self, start: int, n: int):
        """(shard, rows [lo, hi) of the input, first slab row) for the
        rows ``start .. start + n`` of the database."""
        r = self.rows_per_shard
        for s in range(start // r, min(-(-(start + n) // r), self.n_devices)):
            lo, hi = max(start, s * r), min(start + n, (s + 1) * r)
            yield s, lo - start, hi - start, lo - s * r

    @staticmethod
    def _store(buf: torch.Tensor, at, rows: torch.Tensor) -> None:
        """``buf[at] = rows``; uint16 codes go through int16 views (no CUDA
        indexing kernel takes uint16)."""
        if buf.dtype == torch.uint16:
            buf, rows = buf.view(torch.int16), rows.view(torch.int16)
        buf[at] = rows.to(buf.device)

    def write_rows(self, start: int, rows: torch.Tensor,
                   positions: Optional[torch.Tensor] = None) -> None:
        for s, lo, hi, at in self._pieces(start, rows.shape[0]):
            sl = slice(at, at + hi - lo)
            self._store(self._slab_rows[s], sl, rows[lo:hi])
            if positions is not None:
                self._store(self._slab_pos[s], sl, positions[lo:hi])

    def update_rows(self, indices, vectors) -> None:
        """Overwrite existing rows in place; the rows may lie on any
        shard."""
        idx = np.atleast_1d(np.asarray(indices, np.int64))
        if len(idx) == 0:
            return
        rows = self.encode_rows(self._as_tensor(vectors, self.n_bins))
        if rows.dtype == torch.uint16:
            rows = rows.view(torch.int16)
        with self._buffer_lock:
            if idx.max() >= self.database_size:
                raise IndexError("update_rows beyond database size")
            shard = idx // self.rows_per_shard
            for s in np.unique(shard):
                sel = np.flatnonzero(shard == s)
                at = torch.from_numpy(idx[sel] - s * self.rows_per_shard)
                self._store(self._slab_rows[s],
                            at.to(self._slab_rows[s].device),
                            rows[torch.from_numpy(sel).to(rows.device)])

    def rank(self, queries: torch.Tensor, filters: torch.Tensor, top_k: int,
             eff_size) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local ranking on every slab, then the global top-k of their
        (Q, n_shards · k) candidates on ``mesh.devices[0]``. ``eff_size``
        (an int, or the query step's staged 0-d int64) is clamped into
        each slab on the device."""
        k = int(min(top_k, self.capacity))
        r = self.rows_per_shard
        idx, dist = [], []
        with self._buffer_lock:
            for s, (rows, pos) in enumerate(zip(self._slab_rows,
                                                self._slab_pos)):
                local = (torch.as_tensor(eff_size, device=rows.device)
                         - s * r).clamp(0, r)
                i, d = query_math(rows, pos, local, queries.to(rows.device),
                                  filters.to(rows.device), min(k, r),
                                  self.metric, self.epsilon)
                idx.append((i + s * r).to(self.device))
                dist.append(d.to(self.device))
        top_dist, at = smallest_k(torch.cat(dist, dim=1), k)
        return torch.cat(idx, dim=1).gather(1, at), top_dist

    def _ranked(self, queries, filters: np.ndarray, top_k: int,
                eff_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """``query`` and ``query_batch`` rank through the query step
        (``retriever.QueryExecutable`` over ``rank``) on a one-device
        mesh; over distinct cards through ``rank`` op by op (no graph
        spans the slabs' devices; counted as
        ``retriever.STATS["sharded"]``)."""
        if self.mesh.one_device:
            return super()._ranked(queries, filters, top_k, eff_size)
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        f = torch.from_numpy(filters).to(self.device)
        idx, dist = self.rank(q, f, top_k, eff_size)
        _retriever.STATS["sharded"] += 1
        return idx.cpu().numpy(), dist.cpu().numpy()
