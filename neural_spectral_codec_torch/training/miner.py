"""Triplet mining: all-pairs masks per anchor chunk and a hard-negative
W₁ argmin over database tiles. Port of ``neural_spectral_codec_tpu/
training/miner.py``.

Semantics (reference ``triplet_miner.py``):
  * positives: distance < 5 m AND temporal gap ≥ 30 frames
  * negatives: 10 m ≤ distance ≤ 50 m AND temporal gap ≥ 30 frames
  * hard negative = the candidate with the smallest W₁ distance to the
    anchor; "semi-hard" = the median candidate; "random" = uniform
  * per-sequence mining when sequence ids are given

Anchors run in chunks of 2048; each chunk holds (chunk, n) masks and
distances. The hard-negative search walks the database in 4096-row tiles
with ``torch.cdist(p=1)`` on the CDFs and keeps a running min, so no
(chunk, tile, D) temporary is ever built. Positives (and random
negatives) are drawn with ``torch.multinomial`` from the miner's
``torch.Generator``: the JAX package's ``jax.random.categorical`` draws
cannot be reproduced, only their support (the masks).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device

ANCHOR_CHUNK = 2048
TILE = 4096
STRATEGIES = ("hard", "semi-hard", "random")


def _draw(mask: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One uniform draw per row among its True columns (rows without one
    draw among all columns; the miner marks them invalid)."""
    has = mask.any(dim=1, keepdim=True)
    w = torch.where(has, mask, True).to(torch.float32)
    return torch.multinomial(w, 1, generator=generator)[:, 0]


def _w1_tiles(acdf: torch.Tensor, cdfs: torch.Tensor):
    """Yield (start, (chunk, tile) W₁ block) over ``TILE``-row tiles."""
    for t0 in range(0, cdfs.shape[0], TILE):
        yield t0, torch.cdist(acdf[None], cdfs[None, t0:t0 + TILE],
                              p=1.0)[0]


def hard_negatives(acdf: torch.Tensor, cdfs: torch.Tensor,
                   neg_mask: torch.Tensor) -> torch.Tensor:
    """Per anchor row, the index of the masked candidate with the least
    W₁ (index 0 when none): a running min over tiles; the earlier index
    wins a tie, as in the JAX ``fori_loop`` (miner.py:79-96)."""
    count = acdf.shape[0]
    best = torch.full((count,), float("inf"), device=acdf.device)
    best_i = torch.zeros(count, dtype=torch.int64, device=acdf.device)
    for t0, w1 in _w1_tiles(acdf, cdfs):
        w1 = w1.masked_fill(~neg_mask[:, t0:t0 + w1.shape[1]], float("inf"))
        targ = w1.argmin(dim=1)
        tmin = w1.gather(1, targ[:, None])[:, 0]
        upd = tmin < best
        best = torch.where(upd, tmin, best)
        best_i = torch.where(upd, targ + t0, best_i)
    return best_i


def _mine_chunk(positions: torch.Tensor, cdfs: torch.Tensor,
                generator: torch.Generator, params: Tuple[float, ...],
                start: int, count: int, strategy: str):
    """(pos_idx, neg_idx, valid) for anchors ``start .. start+count`` of
    one sequence (JAX ``_mine_chunk``, miner.py:55)."""
    n = positions.shape[0]
    dev = positions.device
    # ‖a − p‖ from per-coordinate differences, as the JAX norm computes it
    a = positions[start:start + count]
    d2 = None
    for c in range(positions.shape[1]):
        diff = a[:, c, None] - positions[None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    d = torch.sqrt(d2)
    del d2, diff
    ai = start + torch.arange(count, dtype=torch.int32, device=dev)
    gap = (ai[:, None]
           - torch.arange(n, dtype=torch.int32, device=dev)[None, :]).abs()
    not_self = gap > 0
    pos_mask = (d < params[0]) & (gap >= params[1]) & not_self
    neg_mask = ((d >= params[2]) & (d <= params[3])
                & (gap >= params[4]) & not_self)
    del d, gap, not_self
    pos_idx = _draw(pos_mask, generator)
    acdf = cdfs[start:start + count]
    if strategy == "hard":
        neg_idx = hard_negatives(acdf, cdfs, neg_mask)
    elif strategy == "semi-hard":
        w1 = torch.cat([w for _, w in _w1_tiles(acdf, cdfs)], dim=1)
        masked = w1.masked_fill(~neg_mask, float("inf"))
        order = torch.sort(masked, dim=1, stable=True).indices
        cnt = neg_mask.sum(dim=1)
        neg_idx = order.gather(1, (cnt // 2)[:, None])[:, 0]
    else:
        neg_idx = _draw(neg_mask, generator)
    valid = pos_mask.any(dim=1) & neg_mask.any(dim=1)
    return pos_idx, neg_idx, valid


def _mine_kernel_chunked(positions: torch.Tensor, cdfs: torch.Tensor,
                         generator: torch.Generator,
                         params: Tuple[float, ...], strategy: str,
                         chunk: int = ANCHOR_CHUNK):
    """All anchors of one sequence in chunks (JAX
    ``_mine_kernel_chunked``, miner.py:29); numpy (pos, neg, valid).
    Each chunk's result is fetched before the next starts, so one
    chunk's (chunk, n) masks are live at a time."""
    n = positions.shape[0]
    outs = [tuple(t.cpu().numpy() for t in _mine_chunk(
        positions, cdfs, generator, params, s, min(s + chunk, n) - s,
        strategy)) for s in range(0, n, chunk)]
    return tuple(np.concatenate([o[i] for o in outs]) for i in range(3))


class TripletMiner:
    """Offline miner over a keyframe set (JAX ``TripletMiner``,
    miner.py:114). Masks, W₁ and draws run on ``device``."""

    def __init__(self, positive_distance_max: float = 5.0,
                 positive_temporal_min: int = 30,
                 negative_distance_min: float = 10.0,
                 negative_distance_max: float = 50.0,
                 negative_temporal_min: int = 30,
                 mining_strategy: str = "hard",
                 seed: int = 0, device: DeviceLike = "cuda"):
        if mining_strategy not in STRATEGIES:
            raise ValueError(f"mining_strategy {mining_strategy!r} not in "
                             f"{STRATEGIES}")
        # float32 thresholds, as the JAX package holds them
        self.params = tuple(float(v) for v in np.array([
            positive_distance_max, positive_temporal_min,
            negative_distance_min, negative_distance_max,
            negative_temporal_min], dtype=np.float32))
        self.mining_strategy = mining_strategy
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def mine_triplets(self, descriptors: np.ndarray, poses: np.ndarray,
                      n_triplets_per_anchor: int = 1,
                      sequence_ids: Optional[np.ndarray] = None
                      ) -> np.ndarray:
        """(T, 3) int64 (anchor, positive, negative) GLOBAL indices.
        Per sequence when ``sequence_ids`` is given: temporal gaps are
        measured within a sequence."""
        positions = poses[:, :3, 3].astype(np.float32)
        cdfs = np.cumsum(
            descriptors / np.maximum(descriptors.sum(1, keepdims=True), 1e-12),
            axis=1).astype(np.float32)
        if sequence_ids is None:
            sequence_ids = np.zeros(len(descriptors), np.int64)
        triplets = []
        for seq in np.unique(sequence_ids):
            sel = np.where(sequence_ids == seq)[0]
            if len(sel) < 3:
                continue
            pos_d = torch.from_numpy(positions[sel]).to(self.device)
            cdf_d = torch.from_numpy(cdfs[sel]).to(self.device)
            for _ in range(n_triplets_per_anchor):
                pos_i, neg_i, valid = _mine_kernel_chunked(
                    pos_d, cdf_d, self._gen, self.params,
                    self.mining_strategy)
                anchors = np.nonzero(valid)[0]
                triplets.append(np.stack([sel[anchors], sel[pos_i[anchors]],
                                          sel[neg_i[anchors]]], axis=1))
        if not triplets:
            return np.zeros((0, 3), np.int64)
        return np.concatenate(triplets, axis=0).astype(np.int64)


def create_triplet_miner(positive_distance_max: float = 5.0,
                         positive_temporal_min: int = 30,
                         negative_distance_min: float = 10.0,
                         negative_distance_max: float = 50.0,
                         negative_temporal_min: int = 30,
                         mining_strategy: str = "hard",
                         seed: int = 0,
                         device: DeviceLike = "cuda") -> TripletMiner:
    return TripletMiner(positive_distance_max, positive_temporal_min,
                        negative_distance_min, negative_distance_max,
                        negative_temporal_min, mining_strategy, seed, device)


class BatchTripletMiner:
    """In-batch online miner, numpy. Copied from JAX
    ``BatchTripletMiner`` (miner.py:176): hard positive = farthest
    same-label, hard negative = closest different-label; semi-hard =
    closest negative inside (d_pos, d_pos + margin), else the hardest."""

    def __init__(self, margin: float = 0.1, mining_strategy: str = "hard",
                 seed: int = 0):
        self.margin = margin
        self.mining_strategy = mining_strategy
        self._rng = np.random.default_rng(seed)

    @staticmethod
    def _pairwise_distances(embeddings: np.ndarray) -> np.ndarray:
        dot = embeddings @ embeddings.T
        sq = np.diag(dot)[None, :]
        d2 = np.clip(sq + sq.T - 2.0 * dot, 0.0, None)
        return np.sqrt(d2)

    def mine_batch_triplets(self, embeddings: np.ndarray, labels: np.ndarray):
        """(anchors, positives, negatives) embedding arrays of shape
        (n_valid, D); anchors without a positive AND a negative drop."""
        embeddings = np.asarray(embeddings)
        labels = np.asarray(labels)
        n = len(embeddings)
        d = self._pairwise_distances(embeddings)
        same = labels[None, :] == labels[:, None]
        pos_mask = same & ~np.eye(n, dtype=bool)
        neg_mask = ~same
        has_pos = pos_mask.any(axis=1)
        has_neg = neg_mask.any(axis=1)
        valid = has_pos & has_neg

        if self.mining_strategy == "hard":
            pos_idx = np.where(pos_mask, d, -1.0).argmax(axis=1)
            neg_idx = np.where(neg_mask, d, np.inf).argmin(axis=1)
        elif self.mining_strategy == "semi-hard":
            pos_idx = np.where(pos_mask, d, -1.0).argmax(axis=1)
            d_pos = d[np.arange(n), pos_idx]
            nd = np.where(neg_mask, d, np.inf)
            band = (nd > d_pos[:, None]) & (nd < (d_pos + self.margin)[:, None])
            banded = np.where(band, nd, np.inf)
            has_band = np.isfinite(banded).any(axis=1)
            neg_idx = np.where(has_band, banded.argmin(axis=1),
                               nd.argmin(axis=1))
        else:  # random
            pos_idx = np.array([
                self._rng.choice(np.nonzero(pos_mask[i])[0])
                if has_pos[i] else 0 for i in range(n)])
            neg_idx = np.array([
                self._rng.choice(np.nonzero(neg_mask[i])[0])
                if has_neg[i] else 0 for i in range(n)])

        sel = np.nonzero(valid)[0]
        return (embeddings[sel], embeddings[pos_idx[sel]],
                embeddings[neg_idx[sel]])
