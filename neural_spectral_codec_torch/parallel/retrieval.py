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
    inputs are encoded and answers are merged."""

    def __init__(self, mesh: Mesh, n_bins: int = 800,
                 capacity: int = 100_000, epsilon: float = 1e-8,
                 metric: str = "wasserstein", storage: str = "float32"):
        self.mesh = mesh
        self.n_devices = mesh.size
        self.rows_per_shard = -(-capacity // self.n_devices)
        super().__init__(n_bins=n_bins,
                         capacity=self.rows_per_shard * self.n_devices,
                         epsilon=epsilon, metric=metric, storage=storage,
                         device=mesh.devices[0])

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
             eff_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local ranking on every slab, then the global top-k of their
        (Q, n_shards · k) candidates on ``mesh.devices[0]``."""
        k = int(min(top_k, self.capacity))
        r = self.rows_per_shard
        idx, dist = [], []
        with self._buffer_lock:
            for s, (rows, pos) in enumerate(zip(self._slab_rows,
                                                self._slab_pos)):
                local = min(max(eff_size - s * r, 0), r)
                i, d = query_math(rows, pos, local, queries.to(rows.device),
                                  filters.to(rows.device), min(k, r),
                                  self.metric, self.epsilon)
                idx.append((i + s * r).to(self.device))
                dist.append(d.to(self.device))
        top_dist, at = smallest_k(torch.cat(dist, dim=1), k)
        return torch.cat(idx, dim=1).gather(1, at), top_dist

    def _ranked(self, queries, filters: np.ndarray, top_k: int,
                eff_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """``query`` and ``query_batch`` rank through ``rank``, op by op
        (no query graph spans the slabs' devices; counted as
        ``retriever.STATS["sharded"]``)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        f = torch.from_numpy(filters).to(self.device)
        idx, dist = self.rank(q, f, top_k, eff_size)
        _retriever.STATS["sharded"] += 1
        return idx.cpu().numpy(), dist.cpu().numpy()
