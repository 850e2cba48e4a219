"""Triplet margin loss. Port of ``neural_spectral_codec_tpu/training/
loss.py``:

    L(a, p, n) = mean(relu(‖a − p‖² − ‖a − n‖² + margin))

with an optional validity mask, so a padded triplet batch averages over
its valid triplets only.
"""

from __future__ import annotations

from typing import Optional

import torch


def l2_normalize(x: torch.Tensor, epsilon: float = 1e-12) -> torch.Tensor:
    """Rows scaled to unit L2 norm, the norm floored at ``epsilon`` (JAX
    ``l2_normalize``, loss.py:16)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(
        min=epsilon)


def triplet_terms(anchors: torch.Tensor, positives: torch.Tensor,
                  negatives: torch.Tensor, margin: float = 0.1,
                  normalize: bool = False) -> torch.Tensor:
    """Each triplet's relu(‖a − p‖² − ‖a − n‖² + margin); ``normalize``
    L2-normalises the embeddings first."""
    if normalize:
        anchors = l2_normalize(anchors)
        positives = l2_normalize(positives)
        negatives = l2_normalize(negatives)
    pos_d = ((anchors - positives) ** 2).sum(dim=1)
    neg_d = ((anchors - negatives) ** 2).sum(dim=1)
    return torch.clamp(pos_d - neg_d + margin, min=0.0)


def triplet_loss(anchors: torch.Tensor, positives: torch.Tensor,
                 negatives: torch.Tensor, margin: float = 0.1,
                 mask: Optional[torch.Tensor] = None,
                 normalize: bool = False) -> torch.Tensor:
    """JAX ``triplet_loss`` (loss.py:21). ``normalize`` L2-normalises the
    embeddings before the squared-distance margin (off by default, as in
    the reference); ``mask`` (bool, one per triplet) averages over the
    valid triplets, at least one."""
    per = triplet_terms(anchors, positives, negatives, margin, normalize)
    if mask is None:
        return per.mean()
    m = mask.to(per.dtype)
    return (per * m).sum() / m.sum().clamp(min=1.0)
