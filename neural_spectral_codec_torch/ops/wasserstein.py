"""1-D Wasserstein (W₁) distance for spectral-histogram retrieval.

Port of ``neural_spectral_codec_tpu/ops/wasserstein.py:20-61``.
W₁(p, q) = Σ_i |CDF_p[i] − CDF_q[i]| for same-support histograms; the
retrieval database stores CDFs so a query is one |Δ|-sum per row.
"""

from __future__ import annotations

import torch


def _normalize(h: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Row-wise sum-to-1 guard: rows with sum ≤ ε are left untouched."""
    s = h.sum(dim=-1, keepdim=True)
    return torch.where(s > epsilon, h / (s + epsilon), h)


def histogram_cdf(h: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Normalized-then-cumsum CDF, the retrieval database storage format."""
    return torch.cumsum(_normalize(h, epsilon), dim=-1)


def wasserstein_batch_from_cdf(query_cdf: torch.Tensor,
                               database_cdf: torch.Tensor) -> torch.Tensor:
    """Both sides already CDFs: (D,) query vs (N, D) database → (N,)."""
    return (database_cdf - query_cdf[None, :]).abs().sum(dim=-1)
