"""Device-resident W₁ retrieval database.

Port of ``neural_spectral_codec_tpu/retrieval/retriever.py``
(``WassersteinRetriever``, float32 storage). A preallocated
(capacity, n_bins) row buffer and (capacity, 3) position buffer live on
the device and are updated in place. A query is W₁ (or L2) against every
row, a mask that sends rows ≥ the effective size and rows spatially
nearer than ``min_d`` (when ``min_d > 0``) to +inf, then an exact
smallest-k with ``torch.topk``. uint16 storage and ``update_rows`` are
not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.ops.wasserstein import histogram_cdf


_MAX_TEMP = 1 << 28   # elements of one (queries, rows, n_bins) temporary


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


def query_math(db_rows: torch.Tensor, db_pos: torch.Tensor, size: int,
               queries: torch.Tensor, query_pos_and_filters: torch.Tensor,
               top_k: int, metric: str = "wasserstein",
               epsilon: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ranking (JAX ``_query_math`` / ``_query_batch_kernel``,
    retriever.py:107-159) for (Q, n_bins) queries and (Q, 4)
    [x, y, z, min_d] filters → (Q, k) indices and distances, smallest
    first; masked rows carry +inf."""
    n = db_rows.shape[0]
    dists = _distances(db_rows, queries, metric, epsilon)
    invalid = (torch.arange(n, device=db_rows.device) >= size)[None, :]
    qp = query_pos_and_filters[:, :3]
    min_d = query_pos_and_filters[:, 3:4]
    spatial = torch.linalg.vector_norm(
        db_pos[None, :, :] - qp[:, None, :], dim=2) < min_d
    masked = torch.where(invalid | ((min_d > 0) & spatial), torch.inf, dists)
    top_dist, top_idx = torch.topk(masked, top_k, dim=1, largest=False)
    return torch.clamp(top_idx, max=n - 1), top_dist


class WassersteinRetriever:
    """Append-only descriptor database with device-side top-k queries.

    ``metric="wasserstein"`` stores normalised-histogram CDFs and ranks by
    1-D W₁; ``metric="l2"`` stores raw vectors (e.g. GNN embeddings) and
    ranks by L2."""

    def __init__(self, n_bins: int = 800, capacity: int = 100_000,
                 epsilon: float = 1e-8, metric: str = "wasserstein",
                 device: DeviceLike = "cuda"):
        if metric not in ("wasserstein", "l2"):
            raise ValueError(f"unknown metric: {metric}")
        self.n_bins = n_bins
        self.capacity = capacity
        self.epsilon = epsilon
        self.metric = metric
        self.device = resolve_device(device)
        self.database_size = 0
        self._db_rows = torch.zeros((capacity, n_bins), dtype=torch.float32,
                                    device=self.device)
        self._db_pos = torch.zeros((capacity, 3), dtype=torch.float32,
                                   device=self.device)

    def _as_tensor(self, a, width: int) -> torch.Tensor:
        t = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        return t.reshape(-1, width)

    def encode_rows(self, vectors: torch.Tensor) -> torch.Tensor:
        """Histogram rows → stored rows (CDFs under W₁, raw under L2)."""
        if self.metric == "wasserstein":
            return histogram_cdf(vectors, self.epsilon)
        return vectors

    def add_to_database(self, histograms, positions=None) -> None:
        """Insert (n, n_bins) vectors (numpy or tensors) in place, with
        optional (n, 3) positions for spatial filtering."""
        h = self._as_tensor(histograms, self.n_bins)
        n = h.shape[0]
        if self.database_size + n > self.capacity:
            raise ValueError(f"Database capacity exceeded: "
                             f"{self.database_size}+{n} > {self.capacity}")
        sl = slice(self.database_size, self.database_size + n)
        self._db_rows[sl] = self.encode_rows(h)
        if positions is not None:
            self._db_pos[sl] = self._as_tensor(positions, 3)
        self.database_size += n

    def effective_size(self, exclude_last: int = 0,
                       as_of_size: Optional[int] = None) -> int:
        size0 = self.database_size if as_of_size is None else \
            min(int(as_of_size), self.database_size)
        return max(size0 - max(exclude_last, 0), 0)

    def rank(self, queries: torch.Tensor, filters: torch.Tensor, top_k: int,
             eff_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-side ranking of (Q, n_bins) queries with (Q, 4) filters
        against the first ``eff_size`` rows → (Q, k) tensors; k is clamped
        by capacity, and slots past the valid rows carry +inf."""
        return query_math(self._db_rows, self._db_pos, eff_size, queries,
                          filters, int(min(top_k, self.capacity)),
                          self.metric, self.epsilon)

    def _filters(self, q: int, positions, spatial_min_distance: float):
        qp = np.zeros((q, 4), np.float32)
        if positions is not None and spatial_min_distance > 0:
            qp[:, :3] = np.asarray(positions, np.float32).reshape(-1, 3)
            qp[:, 3] = spatial_min_distance
        return torch.from_numpy(qp).to(self.device)

    def query(self, query_hist, top_k: int = 10,
              query_position: Optional[np.ndarray] = None,
              spatial_min_distance: float = 0.0, exclude_last: int = 0,
              as_of_size: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k matches of one query → (indices, distances) as numpy,
        trimmed to finite entries."""
        eff = self.effective_size(exclude_last, as_of_size)
        if eff == 0:
            return np.array([], np.int64), np.array([])
        q = self._as_tensor(query_hist, self.n_bins)
        idx, dist = self.rank(q, self._filters(1, query_position,
                                               spatial_min_distance),
                              top_k, eff)
        idx, dist = idx[0].cpu().numpy(), dist[0].cpu().numpy()
        keep = np.isfinite(dist)
        return idx[keep], dist[keep]

    def query_batch(self, query_hists, top_k: int = 10,
                    query_positions: Optional[np.ndarray] = None,
                    spatial_min_distance: float = 0.0, exclude_last: int = 0,
                    as_of_size: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, n_bins) queries → (Q, k) indices and distances as numpy;
        excluded or empty slots carry distance inf and index −1."""
        q = self._as_tensor(query_hists, self.n_bins)
        eff = self.effective_size(exclude_last, as_of_size)
        if eff == 0:
            return (np.zeros((q.shape[0], 0), np.int64),
                    np.zeros((q.shape[0], 0)))
        idx, dist = self.rank(q, self._filters(q.shape[0], query_positions,
                                               spatial_min_distance),
                              top_k, eff)
        idx, dist = idx.cpu().numpy().astype(np.int64), dist.cpu().numpy()
        return np.where(np.isfinite(dist), idx, -1), dist
