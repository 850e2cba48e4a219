"""Evaluation and benchmark suite of the port (``evaluation.py`` of the
JAX package, on one device):

  * ``evaluate_place_recognition``: Recall@K and a thresholded
    precision/recall/F1 curve over revisit queries (a revisit is another
    frame less than ``distance_threshold`` away and more than
    ``skip_frames`` older), ranked on ``device`` in query chunks, each
    chunk one step of a ``RankExecutable`` (on a card, one replay of a
    captured CUDA graph);
  * ``run_benchmark``: per sequence, keyframe descriptors (the batch
    encoders, so the projection or ring-fold kernel and the spectral
    kernel on a CUDA device) → the GNN when weights are loaded →
    metrics and timing, written as one results JSON;
  * the self-checks ``rotation_invariance_check`` and
    ``quantization_error_stats``.

Every function runs on ``"cuda"`` unless the caller names the CPU.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.retrieval.retriever import (  # noqa: F401
    smallest_k)
from neural_spectral_codec_torch.utils.graph_exec import (
    Arena, ExecutableCache, GraphStep, SharedPool)

logger = logging.getLogger(__name__)

POOL = SharedPool()     # every ranking graph of a device: one memory pool
STATS = {"captures": 0, "replays": 0, "eager_steps": 0}
_CACHE = ExecutableCache()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _hit_chunk(emb64: torch.Tensor, sq: torch.Tensor, pos: torch.Tensor,
               q: torch.Tensor, kmax: int, distance_threshold: float,
               skip_frames: int):
    """(hits (c, kmax) bool, top-1 embedding distance (c,)) of the queries
    ``q`` (JAX ``_hit_chunk``, evaluation.py:79): squared distances by
    ``|q|² + |e|² − 2 q·e`` in float32 (no (c, n, D) temporary), frames
    within ``skip_frames`` of the query excluded, the ``kmax`` nearest,
    a hit where the match lies within ``distance_threshold``.

    ``emb64`` holds the float32 embeddings widened to float64 and ``sq``
    their squared norms rounded to float32: the products of float32
    values are exact in float64 and their sums round once to float32, so
    each of the three terms is the same float32 value on every device and
    in any accumulation order (cuBLAS and the CPU sum a float32 product in
    different orders, and the identity cancels near 0: the top-1
    distances, and the thresholds of the P/R curve taken from them, would
    differ between the card and the CPU). The (c, n) blocks are updated in
    place where the order of the operations allows it, so the chunk's
    temporaries stay few."""
    dot = (emb64[q] @ emb64.T).to(torch.float32)
    d2 = torch.add(sq[q][:, None], sq[None, :]).sub_(dot.mul_(2.0))
    j = torch.arange(emb64.shape[0], device=emb64.device)[None, :]
    d2.masked_fill_((j >= (q - skip_frames)[:, None])
                    & (j <= (q + skip_frames)[:, None]), torch.inf)
    top_d2, topk = smallest_k(d2, kmax)
    geo = torch.linalg.vector_norm(pos[q][:, None, :] - pos[topk], dim=-1)
    top1 = torch.sqrt(torch.clamp(top_d2[:, 0], min=0.0))
    # +inf slots (fewer than kmax frames outside the window) carry real
    # column indices: never count them as hits
    hit = (geo < distance_threshold) & torch.isfinite(top_d2)
    return hit, top1


class RankExecutable(GraphStep):
    """JAX's jitted ``_hit_chunk`` (evaluation.py:82) for one (device, n
    embeddings, width D, query chunk c, kmax, skip_frames): the float64
    embeddings, their float32 squared norms and the positions in the
    device arena ``data`` (``load``, once a call), a chunk of query indices
    and the distance threshold staged a chunk; out the (c, kmax) ``hits``
    and the (c,) top-1 distances ``top1``."""

    def __init__(self, n: int, dim: int, chunk: int, kmax: int,
                 skip_frames: int, device: torch.device,
                 use_graph: bool = True):
        super().__init__(device, use_graph, POOL, STATS)
        self.kmax, self.skip_frames = kmax, skip_frames
        self.data = Arena([("emb64", (n, dim), torch.float64),
                           ("sq", (n,), torch.float32),
                           ("positions", (n, 3), torch.float32)], device,
                          host=False)
        self.inputs = Arena([("queries", (chunk,), torch.int64),
                             ("threshold", (), torch.float32)], device)
        self.outputs = Arena([("hits", (chunk, kmax), torch.bool),
                              ("top1", (chunk,), torch.float32)], device)

    def _step(self) -> None:
        d, i, o = self.data.dev, self.inputs.dev, self.outputs.dev
        hit, top1 = _hit_chunk(d["emb64"], d["sq"], d["positions"],
                               i["queries"], self.kmax, i["threshold"],
                               self.skip_frames)
        o["hits"].copy_(hit)
        o["top1"].copy_(top1)


def cached_executables() -> list:
    """The ranking executables in the cache, oldest first."""
    return _CACHE.values()


def clear_cache() -> None:
    """Drop every cached ranking executable (and with them their
    graphs)."""
    _CACHE.clear()


def evaluate_place_recognition(embeddings: np.ndarray, poses: np.ndarray,
                               k_values: Sequence[int] = (1, 5, 10),
                               distance_threshold: float = 5.0,
                               skip_frames: int = 30,
                               query_chunk: int = 4096,
                               n_curve_points: int = 20,
                               device: DeviceLike = "cuda",
                               use_graph: bool = True
                               ) -> Dict[str, float]:
    """Recall@K plus a thresholded precision/recall/F1 curve over revisit
    queries (JAX ``evaluate_place_recognition``, evaluation.py:37).

    The queries are ranked in chunks of c = ``query_chunk`` when there are
    more queries than that, else all of them, as JAX's (its :115, the last
    chunk padded with its last query and trimmed after), so one
    ``RankExecutable`` serves every chunk; on a card each chunk is one
    graph replay with ``use_graph``, without it the same step runs
    eagerly. The executable stays cached, and its graph's pool reserved,
    until ``clear_cache()``, which ``run_benchmark`` calls when it
    returns.

    A query's top-1 match is accepted iff its embedding distance ≤ τ, τ
    swept over the observed top-1 distance quantiles and +inf:
    precision(τ) = accepted and correct / accepted, recall(τ) = accepted
    and correct / queries. Reported as ``precision_recall_curve`` with
    the best-F1 operating point; ``precision@1`` and ``f1@1`` are the
    rank-1 accuracy (≡ recall@1), kept for the config's metric names."""
    from neural_spectral_codec_torch.training.validation import (
        find_revisit_queries)

    dev = resolve_device(device)
    positions = poses[:, :3, 3]
    queries = find_revisit_queries(positions, distance_threshold,
                                   skip_frames, device=dev)
    out: Dict[str, float] = {"n_queries": len(queries)}
    if len(queries) == 0:
        for k in k_values:
            out[f"recall@{k}"] = 0.0
        out.update({"precision@1": 0.0, "f1@1": 0.0, "best_f1": 0.0,
                    "best_f1_tau": 0.0, "precision_at_best_f1": 0.0,
                    "recall_at_best_f1": 0.0,
                    "precision_recall_curve": {
                        "tau": [], "precision": [], "recall": [], "f1": []}})
        return out

    emb64 = torch.from_numpy(np.asarray(embeddings, np.float32)).to(
        dev, torch.float64)
    sq = (emb64 * emb64).sum(dim=1).to(torch.float32)
    pos = torch.from_numpy(np.asarray(positions, np.float32)).to(dev)
    kmax = max(k_values)
    qs = queries[:, 0].astype(np.int64)
    c = query_chunk if len(qs) > query_chunk else len(qs)
    n, dim = emb64.shape
    exe = _CACHE.get((str(dev), n, dim, c, kmax, int(skip_frames),
                      use_graph and dev.type == "cuda"),
                     lambda: RankExecutable(n, dim, c, kmax,
                                            int(skip_frames), dev,
                                            use_graph))
    exe.load(exe.data, {"emb64": emb64, "sq": sq, "positions": pos})
    thr = np.float32(distance_threshold)
    parts, dparts = [], []
    with torch.no_grad():
        for s in range(0, len(qs), c):
            part = qs[s:s + c]
            got = len(part)
            if got < c:
                part = np.concatenate([part, np.repeat(part[-1:], c - got)])
            res, _ = exe.run({"queries": part, "threshold": thr})
            parts.append(res["hits"][:got])
            dparts.append(res["top1"][:got])
    hit = np.concatenate(parts)                   # (Q, kmax)
    top1_dist = np.concatenate(dparts)            # (Q,)

    for k in k_values:
        out[f"recall@{k}"] = float(hit[:, :k].any(axis=1).mean())
    out["precision@1"] = float(hit[:, 0].mean())
    r, p = out.get("recall@1", 0.0), out["precision@1"]
    out["f1@1"] = 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    # the curve on the host, as the JAX package computes it
    hit1 = hit[:, 0]
    taus = np.unique(np.quantile(
        top1_dist, np.linspace(0.0, 1.0, max(n_curve_points - 1, 2))))
    taus = np.append(taus, np.inf)
    curve = {"tau": [], "precision": [], "recall": [], "f1": []}
    for tau in taus:
        acc = top1_dist <= tau
        n_acc = int(acc.sum())
        tp = float(np.sum(acc & hit1))
        prec = tp / n_acc if n_acc else 1.0
        rec = tp / len(hit1)
        f1 = 2 * prec * rec / (prec + rec) if (prec + rec) > 0 else 0.0
        curve["tau"].append(float(tau))
        curve["precision"].append(prec)
        curve["recall"].append(rec)
        curve["f1"].append(f1)
    best = int(np.argmax(curve["f1"]))
    out["precision_recall_curve"] = curve
    out["best_f1"] = curve["f1"][best]
    out["best_f1_tau"] = curve["tau"][best]
    out["precision_at_best_f1"] = curve["precision"][best]
    out["recall_at_best_f1"] = curve["recall"][best]
    return out


# ---------------------------------------------------------------------------
# self-checks
# ---------------------------------------------------------------------------

def rotation_invariance_check(points: np.ndarray, encoder_config,
                              alpha: float = 2.0, n_rotations: int = 8,
                              max_points: int = 131072,
                              device: DeviceLike = "cuda"
                              ) -> Dict[str, float]:
    """Encode a scan at ``n_rotations`` z-rotations in one batch on
    ``device``; the max and mean over rotations of the largest descriptor
    difference from the unrotated scan (JAX evaluation.py:166)."""
    from neural_spectral_codec_torch.ops.range_image import pad_points
    from neural_spectral_codec_torch.ops.spectral import encode_points_batch

    batch = []
    for i in range(n_rotations):
        th = 2 * np.pi * i / n_rotations
        R = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0],
                      [0, 0, 1]], np.float32)
        p = points.copy()
        p[:, :3] = p[:, :3] @ R.T
        batch.append(pad_points(p, max_points))
    dev = resolve_device(device)
    d = encode_points_batch(torch.from_numpy(np.stack(batch)).to(dev),
                            alpha, encoder_config).cpu().numpy()
    diffs = np.abs(d - d[0]).max(axis=1)
    return {"max_difference": float(diffs.max()),
            "mean_difference": float(diffs.mean()),
            "n_rotations": n_rotations}


def quantization_error_stats(histogram: np.ndarray,
                             device: DeviceLike = "cuda") -> Dict[str, float]:
    """Quantize/dequantize round-trip error of a histogram (JAX
    evaluation.py:192)."""
    from neural_spectral_codec_torch.ops.quantization import (
        dequantize, quantize)

    h = np.asarray(histogram, np.float32)
    h = h / max(h.sum(), 1e-12)
    dev = resolve_device(device)
    rec = dequantize(quantize(torch.from_numpy(h).to(dev))).cpu().numpy()
    err = np.abs(rec - h)
    return {"max_error": float(err.max()),
            "mean_error": float(err.mean()),
            "sum_preserved": bool(abs(rec.sum() - 1.0) < 1e-5)}


# ---------------------------------------------------------------------------
# full benchmark
# ---------------------------------------------------------------------------

def run_benchmark(loaders: Sequence, config: Dict,
                  checkpoint_path: Optional[str] = None,
                  results_path: Optional[str] = None,
                  device: DeviceLike = "cuda") -> Dict:
    """Per sequence: keyframes → descriptors → the GNN (when a checkpoint
    is loaded and ``ablation.disable_gnn`` is off) → place-recognition
    metrics and timing (JAX evaluation.py:211). Sequences with fewer than
    3 keyframes are skipped; ``mean`` averages recall@k and best F1 over
    the rest. ``encode_time_s`` and ``avg_query_time_ms`` are wall clock,
    read after the device has finished."""
    from neural_spectral_codec_torch.keyframe.graph import (
        build_graph_from_keyframes, graph_to_tensors)
    from neural_spectral_codec_torch.models.gnn import gnn_forward
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline)

    dev = resolve_device(device)
    bench_cfg = config.get("benchmark", {})
    val_cfg = config.get("validation", {})
    k_values = sorted({int(m.split("@")[1]) for m in bench_cfg.get(
        "metrics", ["recall@1", "recall@5", "recall@10"])
        if m.startswith("recall@")}) or [1, 5, 10]

    pipe = NeuralSpectralCodecPipeline(config, device=dev)
    if checkpoint_path:
        pipe.load_checkpoint(checkpoint_path)

    results: Dict = {"sequences": {}, "config": {
        "k_values": k_values,
        "distance_threshold": val_cfg.get("recall_distance_threshold", 5.0),
        "skip_frames": val_cfg.get("skip_frames", 30),
    }}

    quality = config.get("quality", {})
    if quality.get("check_rotation_invariance", False) and loaders:
        frame = loaders[0][0]
        inv = rotation_invariance_check(
            np.nan_to_num(frame["points"]), pipe.encoder_config,
            alpha=pipe.encoder_config.alpha,
            max_points=pipe.encoder.max_points, device=dev)
        threshold = quality.get("rotation_invariance_threshold", 1e-3)
        inv["passed"] = bool(inv["max_difference"] < threshold)
        results["rotation_invariance"] = inv
        logger.info("Rotation invariance: %s", inv)
    for i, loader in enumerate(loaders):
        seq_name = getattr(loader, "sequence", str(i))
        t0 = time.perf_counter()
        kfs = pipe._process_sequence(loader, sequence_id=i)
        _sync(dev)
        t_encode = time.perf_counter() - t0
        if len(kfs) < 3:
            logger.warning("Sequence %s: too few keyframes, skipping",
                           seq_name)
            continue
        desc = np.stack([kf.descriptor for kf in kfs])
        poses = np.stack([kf.pose for kf in kfs])

        # ablation.disable_gnn wins even when a checkpoint set the weights
        if pipe.weights_loaded and not pipe.ablate_gnn:
            graph = build_graph_from_keyframes(
                kfs, temporal_neighbors=pipe.temporal_neighbors)
            emb = gnn_forward(pipe._serving_model(),
                              graph_to_tensors(graph, dev)).cpu().numpy()
        else:
            emb = desc

        t1 = time.perf_counter()
        metrics = evaluate_place_recognition(
            emb, poses, k_values,
            distance_threshold=results["config"]["distance_threshold"],
            skip_frames=results["config"]["skip_frames"], device=dev)
        _sync(dev)
        metrics["avg_query_time_ms"] = (
            1e3 * (time.perf_counter() - t1) / max(metrics["n_queries"], 1))
        metrics["encode_time_s"] = t_encode
        metrics["n_keyframes"] = len(kfs)
        results["sequences"][seq_name] = metrics
        logger.info("Benchmark %s: %s", seq_name, metrics)

    if results["sequences"]:
        agg = {}
        for k in k_values:
            agg[f"recall@{k}"] = float(np.mean(
                [m[f"recall@{k}"] for m in results["sequences"].values()]))
        agg["best_f1"] = float(np.mean(
            [m["best_f1"] for m in results["sequences"].values()]))
        results["mean"] = agg

    clear_cache()       # the ranking graphs' pool holds (c, n) temporaries
    if results_path:
        Path(results_path).parent.mkdir(parents=True, exist_ok=True)
        with open(results_path, "w") as f:
            json.dump(results, f, indent=2)
        logger.info("Benchmark results saved to %s", results_path)
    return results
