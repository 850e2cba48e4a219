"""Loop-closure Recall@K validation. Port of ``neural_spectral_codec_tpu/
training/validation.py``.

Reference semantics (``trainer.py:306-387``):
  * queries are revisits: for each earlier frame i, the FIRST later frame
    j ≥ i + skip_frames with pose distance < threshold gives the query
    (j, i), one query per earlier frame;
  * a query j ranks every frame with |i − j| > skip_frames by embedding
    L2 distance; a hit is any of the top K within the distance threshold.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.retrieval.retriever import smallest_k
from neural_spectral_codec_torch.utils.graph_exec import (
    Arena, ExecutableCache, GraphStep, SharedPool)

POOL = SharedPool()     # every validation graph of a device: one memory pool
# sharded_op_by_op: recall chunks over a mesh of distinct cards, op by op
STATS = {"captures": 0, "replays": 0, "eager_steps": 0,
         "sharded_op_by_op": 0}
_CACHE = ExecutableCache()


def _revisit_chunk(p: torch.Tensor, start, count: int, thr2,
                   skip_frames: int):
    """(has, first_j) for rows ``start .. start+count`` (``start`` an int
    or a 0-d device tensor). The squared distance is summed from
    per-coordinate differences (no dot-product identity), so it cannot
    cancel on km-scale trajectories."""
    n = p.shape[0]
    i = start + torch.arange(count, device=p.device)
    rows = p.index_select(0, i)
    d2 = None
    for c in range(p.shape[1]):
        diff = rows[:, c, None] - p[None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    band = torch.arange(n, device=p.device)[None, :] >= (i + skip_frames)[
        :, None]
    hit = (d2 < thr2) & band
    return hit.any(dim=1), hit.to(torch.uint8).argmax(dim=1)


class RevisitExecutable(GraphStep):
    """JAX's ``_revisit_chunk`` (validation.py:24) for one (device, n,
    row chunk c, skip_frames): rows ``start .. start + c`` of the
    trajectory in the device arena ``data`` against all n, ``start`` and
    the squared threshold staged a chunk; out ``has`` (c,) bool and
    ``first_j`` (c,) int64."""

    def __init__(self, n: int, chunk: int, skip_frames: int,
                 device: torch.device, use_graph: bool = True):
        super().__init__(device, use_graph, POOL, STATS)
        self.chunk, self.skip_frames = chunk, skip_frames
        self.data = Arena([("positions", (n, 3), torch.float32)], device,
                          host=False)
        self.inputs = Arena([("start", (), torch.int64),
                             ("thr2", (), torch.float32)], device)
        self.outputs = Arena([("has", (chunk,), torch.bool),
                              ("first_j", (chunk,), torch.int64)], device)

    def _step(self) -> None:
        i, o = self.inputs.dev, self.outputs.dev
        has, first = _revisit_chunk(self.data.dev["positions"], i["start"],
                                    self.chunk, i["thr2"], self.skip_frames)
        o["has"].copy_(has)
        o["first_j"].copy_(first)


def find_revisit_queries(positions: np.ndarray,
                         distance_threshold: float = 5.0,
                         skip_frames: int = 30, row_chunk: int = 2048,
                         device: DeviceLike = "cuda",
                         use_graph: bool = True) -> np.ndarray:
    """(Q, 2) int64 (query j, revisited i), in row chunks of
    ``row_chunk`` on ``device`` (JAX ``find_revisit_queries``,
    validation.py:38): every chunk has c = min(row_chunk, n) rows, the
    last one moved back to end at n (its overlap dropped), so one
    ``RevisitExecutable`` serves them all; on a card each chunk is one
    graph replay with ``use_graph``."""
    dev = resolve_device(device)
    n = len(positions)
    if n == 0:
        return np.zeros((0, 2), np.int64)
    c = min(row_chunk, n)
    exe = _CACHE.get(("revisit", str(dev), n, c, int(skip_frames),
                      use_graph and dev.type == "cuda"),
                     lambda: RevisitExecutable(n, c, int(skip_frames), dev,
                                               use_graph))
    exe.load(exe.data, {"positions": torch.from_numpy(
        np.asarray(positions, np.float32)).to(dev)})
    thr2 = np.float32(float(distance_threshold) ** 2)
    out = []
    for s in range(0, n, c):
        start = min(s, n - c)
        res, _ = exe.run({"start": np.int64(start), "thr2": thr2})
        lo = s - start
        i_local = np.nonzero(res["has"][lo:])[0] + lo
        out.append(np.stack([res["first_j"][i_local], start + i_local],
                            axis=1))
    return (np.concatenate(out).astype(np.int64) if out
            else np.zeros((0, 2), np.int64))


def _recall_math(embeddings: torch.Tensor, positions: torch.Tensor,
                 queries: torch.Tensor, ks: Tuple[int, ...],
                 distance_threshold, skip_frames: int,
                 valid=None) -> torch.Tensor:
    """(len(ks),) int64 numbers of hits among ``queries`` at each k of
    ``ks`` (JAX ``_recall_math``, validation.py:64, which returns one k's
    mean), counting only the rows whose ``valid`` is set when given.
    Squared distances by the dot-product identity, in float32 (TF32 off:
    ``resolve_device``); ranking by d² equals ranking by d, ties by the
    lower index (``smallest_k``), as ``lax.top_k`` orders them. The
    largest k is ranked once: ``smallest_k`` returns it ascending, so each
    smaller k reads its first k places."""
    n = embeddings.shape[0]
    q = queries[:, 0]
    qe = embeddings[q]
    ed = ((qe * qe).sum(dim=1)[:, None]
          + (embeddings * embeddings).sum(dim=1)[None, :]
          - 2.0 * (qe @ embeddings.T))
    j = torch.arange(n, device=q.device)[None, :]
    near = (j >= (q - skip_frames)[:, None]) & (j <= (q + skip_frames)[:, None])
    ed = ed.masked_fill(near, float("inf"))             # temporal neighbours
    top = smallest_k(ed, max(ks))[1]
    geo = torch.linalg.vector_norm(positions[top] - positions[q][:, None, :],
                                   dim=-1)
    hit = geo < distance_threshold                      # (Q, max k)
    if valid is not None:
        hit = hit & valid[:, None]
    return torch.stack([hit[:, :k].any(dim=1).sum() for k in ks])


class RecallExecutable(GraphStep):
    """JAX's ``_recall_kernel`` (validation.py:86) for one (device, n,
    embedding width, query chunk, ks, skip_frames): the embeddings and
    positions in the device arena ``data`` (once a recall pass), a chunk
    of query rows with a validity mask (the last chunk is padded) and the
    threshold staged a chunk; out ``hits``, the valid rows' hit count at
    each k of ``ks``. On a one-device mesh it is also JAX's
    ``_sharded_recall_kernel`` (validation.py:92-106): every query share
    sits on the one device, and each query's hits do not depend on its
    share, so the shares' summed counts are the one chunk's."""

    def __init__(self, n: int, dim: int, chunk: int, ks: Tuple[int, ...],
                 skip_frames: int, device: torch.device,
                 use_graph: bool = True):
        super().__init__(device, use_graph, POOL, STATS)
        self.ks, self.skip_frames = ks, skip_frames
        self.data = Arena([("embeddings", (n, dim), torch.float32),
                           ("positions", (n, 3), torch.float32)], device,
                          host=False)
        self.inputs = Arena([("queries", (chunk, 2), torch.int64),
                             ("valid", (chunk,), torch.bool),
                             ("threshold", (), torch.float32)], device)
        self.outputs = Arena([("hits", (len(ks),), torch.int64)], device)

    def _step(self) -> None:
        d, i = self.data.dev, self.inputs.dev
        self.outputs.dev["hits"].copy_(_recall_math(
            d["embeddings"], d["positions"], i["queries"], self.ks,
            i["threshold"], self.skip_frames, i["valid"]))


def recall_at_ks(embeddings: np.ndarray, poses: np.ndarray,
                 ks: Sequence[int] = (1, 5, 10),
                 distance_threshold: float = 5.0, skip_frames: int = 30,
                 query_chunk: int = 4096, device: DeviceLike = "cuda",
                 mesh=None, use_graph: bool = True
                 ) -> Tuple[Dict[int, float], int]:
    """Recall@k over the revisit queries for every k of ``ks`` in one
    pass; returns ({k: recall}, n_queries). Queries run in chunks of
    ``query_chunk``, so the (Q, n) distance block stays bounded (JAX
    ``recall_loop_closure``, validation.py:110): as there, every chunk has
    ``query_chunk`` rows when there are more queries than that (the last
    padded, here with a validity mask), else all the queries, so one
    ``RecallExecutable`` serves them and ranks the largest k once; on a
    card each chunk is one graph replay with ``use_graph``.

    ``mesh`` (``parallel.Mesh``, in place of ``device``) shards each
    chunk's query axis over its devices, the embeddings replicated: each
    device ranks its contiguous share of the queries and the hit counts
    are summed. The shares may differ by one query, so no repeat-query
    padding (JAX's, for equal shards) is needed and the count equals the
    single-device pass's. On a one-device mesh every share is on that
    device and the summed counts are the unsharded chunk's, so the pass
    is the single-device one (``RecallExecutable``, one graph replay and
    one download a chunk on a card); over distinct cards it runs op by
    op, counted in ``STATS["sharded_op_by_op"]``."""
    ks = tuple(sorted({int(k) for k in ks}))
    if torch.is_tensor(embeddings):
        embeddings = embeddings.detach().cpu().numpy()
    devices = (list(mesh.devices) if mesh is not None
               else [resolve_device(device)])
    positions = poses[:, :3, 3].astype(np.float32)
    queries = find_revisit_queries(positions, distance_threshold,
                                   skip_frames, device=devices[0],
                                   use_graph=use_graph)
    nq = len(queries)
    if nq == 0:
        return {k: 0.0 for k in ks}, 0
    emb = torch.from_numpy(np.asarray(embeddings, np.float32))
    pos = torch.from_numpy(positions)
    hits = np.zeros(len(ks), np.int64)
    if mesh is not None and not mesh.one_device:    # distinct cards
        on = {d: (emb.to(d), pos.to(d)) for d in devices}
        for s in range(0, nq, query_chunk):
            STATS["sharded_op_by_op"] += 1
            shares = np.array_split(queries[s:s + query_chunk], len(devices))
            for d, q in zip(devices, shares):
                if len(q):
                    hits += _recall_math(
                        *on[d], torch.from_numpy(q).to(d), ks,
                        distance_threshold, skip_frames).cpu().numpy()
        return {k: h / nq for k, h in zip(ks, hits.tolist())}, nq
    dev = devices[0]
    c = query_chunk if nq > query_chunk else nq
    n, dim = emb.shape
    exe = _CACHE.get(("recall", str(dev), n, dim, c, ks, int(skip_frames),
                      use_graph and dev.type == "cuda"),
                     lambda: RecallExecutable(n, dim, c, ks,
                                              int(skip_frames), dev,
                                              use_graph))
    exe.load(exe.data, {"embeddings": emb.to(dev), "positions": pos.to(dev)})
    thr = np.float32(distance_threshold)
    for s in range(0, nq, c):
        chunk = queries[s:s + c]
        valid = np.zeros(c, bool)
        valid[:len(chunk)] = True
        if len(chunk) < c:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:],
                                                     c - len(chunk), 0)])
        res, _ = exe.run({"queries": chunk, "valid": valid,
                          "threshold": thr})
        hits += res["hits"]
    return {k: h / nq for k, h in zip(ks, hits.tolist())}, nq


def recall_loop_closure(embeddings: np.ndarray, poses: np.ndarray, k: int = 1,
                        distance_threshold: float = 5.0,
                        skip_frames: int = 30, query_chunk: int = 4096,
                        device: DeviceLike = "cuda",
                        mesh=None, use_graph: bool = True
                        ) -> Tuple[float, int]:
    """Recall@K over the revisit queries; returns (recall, n_queries)
    (JAX ``recall_loop_closure``, validation.py:110): ``recall_at_ks``
    with the one k."""
    recall, nq = recall_at_ks(embeddings, poses, (k,), distance_threshold,
                              skip_frames, query_chunk, device, mesh,
                              use_graph)
    return recall[int(k)], nq


def cached_executables() -> list:
    """The revisit and recall executables in the cache, oldest first."""
    return _CACHE.values()


def clear_cache() -> None:
    """Drop every cached validation executable (and their graphs)."""
    _CACHE.clear()
