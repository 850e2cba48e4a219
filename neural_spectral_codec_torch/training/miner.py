"""Triplet mining: all-pairs masks per anchor chunk and a hard-negative
W₁ argmin. Port of ``neural_spectral_codec_tpu/training/miner.py``.

Semantics (reference ``triplet_miner.py``):
  * positives: distance < 5 m AND temporal gap ≥ 30 frames
  * negatives: 10 m ≤ distance ≤ 50 m AND temporal gap ≥ 30 frames
  * hard negative = the candidate with the smallest W₁ distance to the
    anchor; "semi-hard" = the median candidate; "random" = uniform
  * per-sequence mining when sequence ids are given

Anchors run in chunks of 2048, each chunk JAX's one-dispatch
``_mine_chunk`` as a ``MiningExecutable`` of its strategy: on a card each
chunk is one replay of a captured CUDA graph of kernel M's entries
(``training/mine_kernel.py``, ``csrc/mine.cu``), none of which builds a
(chunk, n) matrix but "semi-hard"'s W₁ block:

  * "hard": the counts and the least-W₁ negative, then the positive draw;
  * "semi-hard": the (chunk, n) W₁ block (+inf outside the negatives) and
    the counts, kernel S (``training/select_kernel.py``, ``csrc/select.cu``)
    at place count_neg // 2 of each row's stable order (JAX's
    ``order[cnt // 2]``), then the positive draw;
  * "random": the counts, then a draw over the positives and one over the
    negatives.

A draw takes the r-th member of its mask in index order with r = min(⌊u ·
count⌋, count − 1), u ~ U[0, 1) drawn from the miner's ``torch.Generator``
(one u an anchor and draw): uniform over the mask, as
``jax.random.categorical`` is, whose bits cannot be reproduced.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.training import mine_kernel, select_kernel
from neural_spectral_codec_torch.utils.graph_exec import (
    Arena, ExecutableCache, GraphStep, SharedPool)

ANCHOR_CHUNK = 2048
TILE = 4096              # the plain versions' frames a tile (CPU steps)
STRATEGIES = ("hard", "semi-hard", "random")
DRAWS = {"hard": 1, "semi-hard": 1, "random": 2}   # u values an anchor
# the kernels each strategy's graph holds, by census name, with their count
CENSUS = {"hard": {"mine": 1, "mine_draw": 1},
          "semi-hard": {"mine_rows": 1, "select": 1, "mine_draw_mask": 1},
          "random": {"mine_counts": 1, "mine_draw_mask": 2}}

POOL = SharedPool()     # every mining graph of a device: one memory pool
# eager_chunks stays 0: every strategy runs its executable (kept so that a
# reader of STATS sees no op-by-op chunk)
STATS = {"captures": 0, "replays": 0, "eager_steps": 0, "eager_chunks": 0}
_CACHE = ExecutableCache()


class MiningExecutable(GraphStep):
    """JAX's ``_mine_chunk`` (miner.py:54) for one (device, sequence length
    n, chunk c, bins, thresholds, strategy): kernel M's entries (and, for
    "semi-hard", kernel S) on anchors ``start .. start + c``, ``start``
    and the draws' u (``DRAWS[strategy]`` rows of c: for "random" the
    positives' first) staged each chunk (``utils/graph_exec.GraphStep``).
    The sequence's positions, CDFs and frame tiles' boxes (the draws'
    ``mine_kernel.tile_boxes``) sit in a device arena (``load_sequence``,
    once a sequence), and so does "semi-hard"'s (c, n)
    W₁ block, at a fixed address. Outputs, fetched in one download a chunk:
    int32 ``pos_idx``, ``neg_idx``, ``count_pos``, ``count_neg`` and bool
    ``valid``."""

    def __init__(self, n: int, chunk: int, bins: int,
                 params: Tuple[float, ...], device: torch.device,
                 use_graph: bool = True, strategy: str = "hard"):
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy {strategy!r} not in {STRATEGIES}")
        super().__init__(device, use_graph, POOL, STATS)
        self.chunk, self.params, self.strategy = chunk, tuple(params), strategy
        f32, i32 = torch.float32, torch.int32
        data = [("positions", (n, 3), f32), ("cdfs", (n, bins), f32),
                ("boxes", (-(-n // mine_kernel.ROWS_PER_TILE), 6), f32)]
        if strategy == "semi-hard":
            data.append(("w1", (chunk, n), f32))
        self.data = Arena(data, device, host=False)
        self.inputs = Arena([("start", (1,), i32),
                             ("u", (DRAWS[strategy], chunk), f32)], device)
        self.outputs = Arena([("pos_idx", (chunk,), i32),
                              ("neg_idx", (chunk,), i32),
                              ("count_pos", (chunk,), i32),
                              ("count_neg", (chunk,), i32),
                              ("valid", (chunk,), torch.bool)], device)

    def load_sequence(self, positions: torch.Tensor,
                      cdfs: torch.Tensor) -> None:
        self.load(self.data, {"positions": positions, "cdfs": cdfs,
                              "boxes": mine_kernel.tile_boxes(positions)})

    def _kernels(self) -> tuple:
        mk = mine_kernel
        return {"hard": (mk.HARD, mk.DRAW),
                "semi-hard": (mk.ROWS, select_kernel.KERNEL, mk.DRAW_MASK),
                "random": (mk.COUNTS, mk.DRAW_MASK)}[self.strategy]

    def _check(self, graph) -> None:
        from neural_spectral_codec_torch._build import graph_census
        self.census = graph_census(graph.raw_cuda_graph())
        want = dict(CENSUS[self.strategy])
        if self.strategy == "semi-hard":     # S's node, in its regime
            want["select_cluster_dim"] = select_kernel.select_layout(
                self.data.dev["w1"].shape[1])
        got = {k: self.census[k] for k in want}
        if got != want:
            raise RuntimeError(f"the {self.strategy} mining graph holds "
                               f"{got} kernel nodes, not {want}")

    def _step(self) -> None:
        d, i, o = self.data.dev, self.inputs.dev, self.outputs.dev
        pos, start, u, boxes = d["positions"], i["start"], i["u"], d["boxes"]
        c, prm, mk = self.chunk, self.params, mine_kernel
        if self.strategy == "hard":
            out = mk.mine(pos, d["cdfs"], start, c, prm, u[0], boxes,
                          tile=TILE)
            for name, value in zip(out._fields, out):
                o[name].copy_(value)
            return
        scratch = (None if pos.device.type == "cpu"
                   else mk.mine_scratch(pos.shape[0], c, pos.device))
        if self.strategy == "semi-hard":
            counts = mk.mine_rows(pos, d["cdfs"], start, c, prm, d["w1"],
                                  scratch, tile=TILE)
            neg = select_kernel.select(d["w1"], counts.count_neg // 2)
        else:
            counts = mk.mine_counts(pos, start, c, prm, scratch, tile=TILE)
            neg = mk.mine_draw(pos, start, c, prm, u[1], counts.count_neg,
                               "neg", boxes, scratch, tile=TILE)
        o["pos_idx"].copy_(mk.mine_draw(pos, start, c, prm, u[0],
                                        counts.count_pos, "pos", boxes,
                                        scratch, tile=TILE))
        o["neg_idx"].copy_(neg)
        for name, value in zip(counts._fields, counts):
            o[name].copy_(value)


def mining_executable(n: int, chunk: int, bins: int,
                      params: Tuple[float, ...], device: torch.device,
                      use_graph: bool = True,
                      strategy: str = "hard") -> MiningExecutable:
    """The cached mining step of (device, n, chunk, bins, thresholds,
    strategy)."""
    graphed = use_graph and device.type == "cuda"
    return _CACHE.get((str(device), int(n), int(chunk), int(bins),
                       tuple(params), strategy, graphed),
                      lambda: MiningExecutable(n, chunk, bins, params,
                                               device, use_graph, strategy))


def cached_executables() -> list:
    """The mining executables in the cache, oldest first."""
    return _CACHE.values()


def clear_cache() -> None:
    """Drop every cached mining executable (and with them their graphs)."""
    _CACHE.clear()


def _mine_kernel_chunked(positions: torch.Tensor, cdfs: torch.Tensor,
                         generator: torch.Generator,
                         params: Tuple[float, ...], strategy: str,
                         chunk: int = ANCHOR_CHUNK, use_graph: bool = True):
    """All anchors of one sequence (JAX ``_mine_kernel_chunked``,
    miner.py:29) through its ``MiningExecutable``; numpy (pos, neg,
    valid). The chunks' starts are s = 0, c, 2c, ... with the last one
    moved back to n − c (JAX's revisit scan does the same,
    validation.py:53), so one graph serves the whole sequence; the last
    chunk keeps only its new anchors. ``DRAWS[strategy]`` × c draws u a
    chunk from ``generator``."""
    n = positions.shape[0]
    c = min(chunk, n)
    exe = mining_executable(n, c, cdfs.shape[1], params, positions.device,
                            use_graph, strategy)
    exe.load_sequence(positions, cdfs)
    outs = []
    for s in range(0, n, c):
        start = min(s, n - c)
        u = torch.rand((DRAWS[strategy], c), generator=generator,
                       device=positions.device)
        out, _ = exe.run({"start": np.array([start], np.int32), "u": u})
        lo = s - start
        outs.append(tuple(out[k][lo:] for k in ("pos_idx", "neg_idx",
                                                "valid")))
    return tuple(np.concatenate([o[i] for o in outs]).astype(
        np.int64 if i < 2 else bool) for i in range(3))


class TripletMiner:
    """Offline miner over a keyframe set (JAX ``TripletMiner``,
    miner.py:114). Masks, W₁ and draws run on ``device``; with
    ``use_graph`` (the default) every chunk replays a captured graph on a
    card, without it the same step runs eagerly."""

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
