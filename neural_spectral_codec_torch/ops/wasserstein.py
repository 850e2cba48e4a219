"""1-D Wasserstein (W₁) distance for spectral-histogram retrieval.

Port of ``neural_spectral_codec_tpu/ops/wasserstein.py``.
W₁(p, q) = Σ_i |CDF_p[i] − CDF_q[i]| for same-support histograms; the
retrieval database stores CDFs so a query is one |Δ|-sum per row.

Two normalisation guards, as in the reference: database-side rows are
divided by ``sum + ε`` (``_normalize``), a single query histogram by its
bare sum (``_normalize_scalar``); rows with sum ≤ ε stay as they are.
The all-pairs variants take |Δ|-sums with ``torch.cdist(p=1)``, so no
(N1, N2, D) temporary is built.
"""

from __future__ import annotations

import torch


def _normalize(h: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Row-wise sum-to-1 guard: rows with sum ≤ ε are left untouched."""
    s = h.sum(dim=-1, keepdim=True)
    return torch.where(s > epsilon, h / (s + epsilon), h)


def _normalize_scalar(h: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Single-histogram guard: divides by the bare sum."""
    s = h.sum(dim=-1, keepdim=True)
    return torch.where(s > epsilon, h / s, h)


def histogram_cdf(h: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Normalized-then-cumsum CDF, the retrieval database storage format."""
    return torch.cumsum(_normalize(h, epsilon), dim=-1)


def wasserstein_1d(h1: torch.Tensor, h2: torch.Tensor,
                   epsilon: float = 1e-8) -> torch.Tensor:
    """W₁ between histograms along the last axis (JAX ``wasserstein_1d``,
    wasserstein.py:40)."""
    c1 = torch.cumsum(_normalize_scalar(h1, epsilon), dim=-1)
    c2 = torch.cumsum(_normalize_scalar(h2, epsilon), dim=-1)
    return (c1 - c2).abs().sum(dim=-1)


def wasserstein_batch(query: torch.Tensor, database: torch.Tensor,
                      epsilon: float = 1e-8) -> torch.Tensor:
    """(D,) query vs (N, D) database → (N,) (JAX ``wasserstein_batch``,
    wasserstein.py:49)."""
    qc = torch.cumsum(_normalize_scalar(query, epsilon), dim=-1)
    return wasserstein_batch_from_cdf(qc, histogram_cdf(database, epsilon))


def wasserstein_batch_from_cdf(query_cdf: torch.Tensor,
                               database_cdf: torch.Tensor) -> torch.Tensor:
    """Both sides already CDFs: (D,) query vs (N, D) database → (N,)."""
    return (database_cdf - query_cdf[None, :]).abs().sum(dim=-1)


def wasserstein_matrix(h1: torch.Tensor, h2: torch.Tensor,
                       epsilon: float = 1e-8) -> torch.Tensor:
    """All-pairs (N1, N2) W₁ matrix (JAX ``wasserstein_matrix``,
    wasserstein.py:65)."""
    return torch.cdist(histogram_cdf(h1, epsilon)[None],
                       histogram_cdf(h2, epsilon)[None], p=1.0)[0]


def wasserstein_matrix_chunked(h1: torch.Tensor, h2: torch.Tensor,
                               epsilon: float = 1e-8,
                               chunk: int = 512) -> torch.Tensor:
    """All-pairs W₁ over row chunks of ``h1`` (JAX
    ``wasserstein_matrix_chunked``, wasserstein.py:78): each chunk's
    (chunk, N2) block is one ``cdist``."""
    c1 = histogram_cdf(h1, epsilon)
    c2 = histogram_cdf(h2, epsilon)[None]
    return torch.cat([torch.cdist(c1[s:s + chunk][None], c2, p=1.0)[0]
                      for s in range(0, c1.shape[0], chunk)]
                     or [c1.new_zeros((0, c2.shape[1]))])
