"""Triplet mining: all-pairs masks per anchor chunk and a hard-negative
W₁ argmin. Port of ``neural_spectral_codec_tpu/training/miner.py``.

Semantics (reference ``triplet_miner.py``):
  * positives: distance < 5 m AND temporal gap ≥ 30 frames
  * negatives: 10 m ≤ distance ≤ 50 m AND temporal gap ≥ 30 frames
  * hard negative = the candidate with the smallest W₁ distance to the
    anchor; "semi-hard" = the median candidate; "random" = uniform
  * per-sequence mining when sequence ids are given

Anchors run in chunks of 2048. The "hard" strategy, the one the training
configuration uses, is JAX's one-dispatch ``_mine_chunk`` as a
``MiningExecutable``: kernel M (``training/mine_kernel.py``,
``csrc/mine.cu``) computes each anchor's masks, counts, hard negative and
positive draw without building a (chunk, n) matrix; on a card each chunk
is one replay of a captured CUDA graph. Its positive is the r-th positive
in index order with r = min(⌊u · count⌋, count − 1), u ~ U[0, 1) drawn
from the miner's ``torch.Generator`` (one u an anchor): uniform over the
positive mask, as ``jax.random.categorical`` is, whose bits cannot be
reproduced. "semi-hard" and "random" run op by op (the declared eager
path, counted in ``STATS["eager_chunks"]``), with (chunk, n) masks and
``torch.multinomial`` draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.training import mine_kernel
from neural_spectral_codec_torch.utils.graph_exec import (
    Arena, ExecutableCache, GraphStep, SharedPool)

ANCHOR_CHUNK = 2048
TILE = 4096
STRATEGIES = ("hard", "semi-hard", "random")

POOL = SharedPool()     # every mining graph of a device: one memory pool
STATS = {"captures": 0, "replays": 0, "eager_steps": 0, "eager_chunks": 0}
_CACHE = ExecutableCache()


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


def _mine_chunk_eager(positions: torch.Tensor, cdfs: torch.Tensor,
                      generator: torch.Generator, params: Tuple[float, ...],
                      start: int, count: int, strategy: str):
    """(pos_idx, neg_idx, valid) for anchors ``start .. start+count`` of
    one sequence, "semi-hard" or "random", op by op (JAX ``_mine_chunk``,
    miner.py:55)."""
    n = positions.shape[0]
    dev = positions.device
    a = torch.arange(start, start + count, dtype=torch.int64, device=dev)
    pos_mask, neg_mask = mine_kernel.chunk_masks(positions, a, 0, n, params)
    pos_idx = _draw(pos_mask, generator)
    acdf = cdfs[start:start + count]
    if strategy == "semi-hard":
        w1 = torch.cat([w for _, w in _w1_tiles(acdf, cdfs)], dim=1)
        masked = w1.masked_fill(~neg_mask, float("inf"))
        order = torch.sort(masked, dim=1, stable=True).indices
        cnt = neg_mask.sum(dim=1)
        neg_idx = order.gather(1, (cnt // 2)[:, None])[:, 0]
    else:
        neg_idx = _draw(neg_mask, generator)
    valid = pos_mask.any(dim=1) & neg_mask.any(dim=1)
    if dev.type == "cuda":
        STATS["eager_chunks"] += 1
    return pos_idx, neg_idx, valid


class MiningExecutable(GraphStep):
    """JAX's ``_mine_chunk`` ("hard", miner.py:54) for one (device,
    sequence length n, chunk c, bins, thresholds): kernel M's two entries
    on anchors ``start .. start + c``, ``start`` and the c draws u staged
    each chunk (``utils/graph_exec.GraphStep``). The sequence's positions
    and CDFs sit in a device arena (``load_sequence``, once a sequence).
    Outputs, fetched in one download a chunk: int32 ``pos_idx``,
    ``neg_idx``, ``count_pos``, ``count_neg`` and bool ``valid``."""

    def __init__(self, n: int, chunk: int, bins: int,
                 params: Tuple[float, ...], device: torch.device,
                 use_graph: bool = True):
        super().__init__(device, use_graph, POOL, STATS)
        self.chunk, self.params = chunk, tuple(params)
        f32, i32 = torch.float32, torch.int32
        self.data = Arena([("positions", (n, 3), f32),
                           ("cdfs", (n, bins), f32)], device, host=False)
        self.inputs = Arena([("start", (1,), i32), ("u", (chunk,), f32)],
                            device)
        self.outputs = Arena([("pos_idx", (chunk,), i32),
                              ("neg_idx", (chunk,), i32),
                              ("count_pos", (chunk,), i32),
                              ("count_neg", (chunk,), i32),
                              ("valid", (chunk,), torch.bool)], device)

    def load_sequence(self, positions: torch.Tensor,
                      cdfs: torch.Tensor) -> None:
        self.load(self.data, {"positions": positions, "cdfs": cdfs})

    def _kernels(self) -> tuple:
        return (mine_kernel.HARD, mine_kernel.DRAW)

    def _check(self, graph) -> None:
        from neural_spectral_codec_torch._build import graph_census
        self.census = graph_census(graph.raw_cuda_graph())
        if (self.census["mine"], self.census["mine_draw"]) != (1, 1):
            raise RuntimeError(f"the mining graph holds {self.census['mine']}"
                               f" counting and {self.census['mine_draw']} "
                               "draw kernels, not one each")

    def _step(self) -> None:
        d, i = self.data.dev, self.inputs.dev
        out = mine_kernel.mine(d["positions"], d["cdfs"], i["start"],
                               self.chunk, self.params, i["u"], tile=TILE)
        for name, value in zip(out._fields, out):
            self.outputs.dev[name].copy_(value)


def mining_executable(n: int, chunk: int, bins: int,
                      params: Tuple[float, ...], device: torch.device,
                      use_graph: bool = True) -> MiningExecutable:
    """The cached mining step of (device, n, chunk, bins, thresholds)."""
    graphed = use_graph and device.type == "cuda"
    return _CACHE.get((str(device), int(n), int(chunk), int(bins),
                       tuple(params), graphed),
                      lambda: MiningExecutable(n, chunk, bins, params,
                                               device, use_graph))


def cached_executables() -> list:
    """The mining executables in the cache, oldest first."""
    return _CACHE.values()


def clear_cache() -> None:
    """Drop every cached mining executable (and with them their graphs)."""
    _CACHE.clear()


def _mine_hard(positions: torch.Tensor, cdfs: torch.Tensor,
               generator: torch.Generator, params: Tuple[float, ...],
               chunk: int, use_graph: bool):
    """Every anchor of one sequence through its ``MiningExecutable``: the
    chunks' starts are s = 0, c, 2c, ... with the last one moved back to
    n − c (JAX's revisit scan does the same, validation.py:53), so one
    graph serves the whole sequence; the last chunk keeps only its new
    anchors. c draws u a chunk. Numpy (pos, neg, valid)."""
    n = positions.shape[0]
    c = min(chunk, n)
    exe = mining_executable(n, c, cdfs.shape[1], params, positions.device,
                            use_graph)
    exe.load_sequence(positions, cdfs)
    outs = []
    for s in range(0, n, c):
        start = min(s, n - c)
        u = torch.rand(c, generator=generator, device=positions.device)
        out, _ = exe.run({"start": np.array([start], np.int32), "u": u})
        lo = s - start
        outs.append(tuple(out[k][lo:] for k in ("pos_idx", "neg_idx",
                                                "valid")))
    return tuple(np.concatenate([o[i] for o in outs]).astype(
        np.int64 if i < 2 else bool) for i in range(3))


def _mine_kernel_chunked(positions: torch.Tensor, cdfs: torch.Tensor,
                         generator: torch.Generator,
                         params: Tuple[float, ...], strategy: str,
                         chunk: int = ANCHOR_CHUNK, use_graph: bool = True):
    """All anchors of one sequence in chunks (JAX
    ``_mine_kernel_chunked``, miner.py:29); numpy (pos, neg, valid).
    "hard" runs the ``MiningExecutable``; the other strategies fetch each
    chunk's result before the next starts, so one chunk's (chunk, n)
    masks are live at a time."""
    if strategy == "hard":
        return _mine_hard(positions, cdfs, generator, params, chunk,
                          use_graph)
    n = positions.shape[0]
    outs = [tuple(t.cpu().numpy() for t in _mine_chunk_eager(
        positions, cdfs, generator, params, s, min(s + chunk, n) - s,
        strategy)) for s in range(0, n, chunk)]
    return tuple(np.concatenate([o[i] for o in outs]) for i in range(3))


class TripletMiner:
    """Offline miner over a keyframe set (JAX ``TripletMiner``,
    miner.py:114). Masks, W₁ and draws run on ``device``; with
    ``use_graph`` (the default) the "hard" chunks replay a captured graph
    on a card, without it they run the same step eagerly."""

    def __init__(self, positive_distance_max: float = 5.0,
                 positive_temporal_min: int = 30,
                 negative_distance_min: float = 10.0,
                 negative_distance_max: float = 50.0,
                 negative_temporal_min: int = 30,
                 mining_strategy: str = "hard",
                 seed: int = 0, device: DeviceLike = "cuda",
                 use_graph: bool = True):
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
        self.use_graph = use_graph
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
                    self.mining_strategy, use_graph=self.use_graph)
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
                         device: DeviceLike = "cuda",
                         use_graph: bool = True) -> TripletMiner:
    return TripletMiner(positive_distance_max, positive_temporal_min,
                        negative_distance_min, negative_distance_max,
                        negative_temporal_min, mining_strategy, seed, device,
                        use_graph)


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
