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

from typing import Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device


def _revisit_chunk(p: torch.Tensor, start: int, count: int, thr2: float,
                   skip_frames: int):
    """(has, first_j) for rows ``start .. start+count``. The squared
    distance is summed from per-coordinate differences (no dot-product
    identity), so it cannot cancel on km-scale trajectories."""
    n = p.shape[0]
    rows = p[start:start + count]
    d2 = None
    for c in range(p.shape[1]):
        diff = rows[:, c, None] - p[None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    first = start + skip_frames + torch.arange(count, device=p.device)
    band = torch.arange(n, device=p.device)[None, :] >= first[:, None]
    hit = (d2 < thr2) & band
    return hit.any(dim=1), hit.to(torch.uint8).argmax(dim=1)


def find_revisit_queries(positions: np.ndarray,
                         distance_threshold: float = 5.0,
                         skip_frames: int = 30, row_chunk: int = 2048,
                         device: DeviceLike = "cuda") -> np.ndarray:
    """(Q, 2) int64 (query j, revisited i), in row chunks of
    ``row_chunk`` on ``device`` (JAX ``find_revisit_queries``,
    validation.py:38)."""
    dev = resolve_device(device)
    n = len(positions)
    p = torch.from_numpy(np.asarray(positions, np.float32)).to(dev)
    thr2 = float(np.float32(float(distance_threshold) ** 2))
    out = []
    for s in range(0, n, row_chunk):
        c = min(row_chunk, n - s)
        has, first_j = _revisit_chunk(p, s, c, thr2, skip_frames)
        has, first_j = has.cpu().numpy(), first_j.cpu().numpy()
        i_local = np.nonzero(has)[0]
        out.append(np.stack([first_j[i_local], s + i_local], axis=1))
    return (np.concatenate(out).astype(np.int64) if out
            else np.zeros((0, 2), np.int64))


def _recall_math(embeddings: torch.Tensor, positions: torch.Tensor,
                 queries: torch.Tensor, k: int, distance_threshold: float,
                 skip_frames: int) -> torch.Tensor:
    """Number of hits among ``queries`` (JAX ``_recall_math``,
    validation.py:64, which returns their mean). Squared distances by the
    dot-product identity, in float32 (TF32 off: ``resolve_device``);
    ranking by d² equals ranking by d."""
    n = embeddings.shape[0]
    q = queries[:, 0]
    qe = embeddings[q]
    ed = ((qe * qe).sum(dim=1)[:, None]
          + (embeddings * embeddings).sum(dim=1)[None, :]
          - 2.0 * (qe @ embeddings.T))
    j = torch.arange(n, device=q.device)[None, :]
    near = (j >= (q - skip_frames)[:, None]) & (j <= (q + skip_frames)[:, None])
    ed = ed.masked_fill(near, float("inf"))             # temporal neighbours
    top = torch.topk(ed, k, dim=1, largest=False).indices
    geo = torch.linalg.vector_norm(positions[top] - positions[q][:, None, :],
                                   dim=-1)
    return (geo < distance_threshold).any(dim=1).sum()


def recall_loop_closure(embeddings: np.ndarray, poses: np.ndarray, k: int = 1,
                        distance_threshold: float = 5.0,
                        skip_frames: int = 30, query_chunk: int = 4096,
                        device: DeviceLike = "cuda",
                        mesh=None) -> Tuple[float, int]:
    """Recall@K over the revisit queries; returns (recall, n_queries).
    Queries run in chunks of ``query_chunk``, so the (Q, n) distance
    block stays bounded (JAX ``recall_loop_closure``, validation.py:110).

    ``mesh`` (``parallel.Mesh``, in place of ``device``) shards each
    chunk's query axis over its devices, the embeddings replicated: each
    device ranks its contiguous share of the queries and the hit counts
    are summed. The shares may differ by one query, so no repeat-query
    padding (JAX's, for equal shards) is needed and the count equals the
    single-device pass's."""
    if torch.is_tensor(embeddings):
        embeddings = embeddings.detach().cpu().numpy()
    devices = (list(mesh.devices) if mesh is not None
               else [resolve_device(device)])
    positions = poses[:, :3, 3].astype(np.float32)
    queries = find_revisit_queries(positions, distance_threshold,
                                   skip_frames, device=devices[0])
    nq = len(queries)
    if nq == 0:
        return 0.0, 0
    emb = torch.from_numpy(np.asarray(embeddings, np.float32))
    pos = torch.from_numpy(positions)
    on = {d: (emb.to(d), pos.to(d)) for d in devices}
    hits = 0
    for s in range(0, nq, query_chunk):
        shares = np.array_split(queries[s:s + query_chunk], len(devices))
        counts = [_recall_math(*on[d], torch.from_numpy(q).to(d), k,
                               distance_threshold, skip_frames)
                  for d, q in zip(devices, shares) if len(q)]
        hits += sum(int(c) for c in counts)
    return hits / nq, nq
