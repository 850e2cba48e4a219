"""The online serving step: one keyframe scan in, one ranked answer out.

Semantics of ``neural_spectral_codec_tpu/models/gnn._jitted_serving_step``
(gnn.py:235-284), in this order:

  1. encode the scan: the ring path for (R, P, 3|4) input with
     ``row_of_ring``, else the general path for (N, 3|4);
  2. write the descriptor into the center node's feature row;
  3. GNN eval forward over the graph;
  4. stage-1 query against ``eff_size = size − (context_window − 1)`` rows
     (before the insert, so the new row is never its own answer);
  5. insert the row (CDF of the descriptor under W₁, the center embedding
     under L2) with its position.

Eager PyTorch needs no single executable, so the steps are a sequence of
calls, made under the retriever's lock (``fused_dispatch``), which hands
out the insert row and the effective size; on a CUDA tensor the encoder
runs the hand-written kernels.
The center feature row is written IN PLACE into ``graph.features``: the
server's graph keeps the node's true descriptor, as the JAX serving loop
writes it back after the step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from neural_spectral_codec_torch.keyframe.graph import KeyframeGraph
from neural_spectral_codec_torch.models.gnn import SpectralGNN
from neural_spectral_codec_torch.ops.ring_path import encode_points_ring_batch
from neural_spectral_codec_torch.ops.spectral import (
    Alpha, SpectralEncoderConfig, encode_points_batch)
from neural_spectral_codec_torch.retrieval.retriever import (
    WassersteinRetriever)


def encode_scan(points: torch.Tensor, alpha: Alpha,
                config: SpectralEncoderConfig,
                row_of_ring: Optional[Sequence[int]] = None,
                n_folds: int = 2) -> torch.Tensor:
    """One scan → its (output_dim,) descriptor: ring path for a
    (R, P, 3|4) scan with ``row_of_ring``, general path for (N, 3|4)."""
    if points.dim() == 3:
        if row_of_ring is None:
            raise ValueError("a ring-structured (R, P, C) scan needs "
                             "row_of_ring")
        return encode_points_ring_batch(points[None], alpha, config,
                                        row_of_ring, n_folds)[0]
    return encode_points_batch(points[None], alpha, config)[0]


def serve_step(retriever: WassersteinRetriever, model: SpectralGNN,
               points: torch.Tensor, alpha: Alpha, graph: KeyframeGraph,
               center: int, qp: torch.Tensor, top_k: int,
               do_query: bool = True, do_insert: bool = True, *,
               config: SpectralEncoderConfig = SpectralEncoderConfig(),
               row_of_ring: Optional[Sequence[int]] = None,
               n_folds: int = 2, context_window: int = 1,
               insert_pos: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run one serving step; returns ``(desc, emb, idx, dist)``.

    ``graph`` holds tensors on the retriever's device
    (``keyframe.graph_to_tensors``); ``qp`` is the (4,) query filter
    [x, y, z, min_d] (min_d ≤ 0 turns the spatial filter off);
    ``insert_pos`` defaults to qp[:3]. ``idx``/``dist`` are the raw (k,)
    top-k (masked slots carry +inf), or None when ``do_query`` is off.
    ``model`` must be in eval mode."""
    if model.training:
        raise ValueError("serve_step runs the eval forward; call "
                         "model.eval() first")

    def step(insert_at: int, eff: int):
        with torch.no_grad():
            desc = encode_scan(points, alpha, config, row_of_ring, n_folds)
            graph.features[center] = desc
            emb = model(graph.features, graph.neighbors, graph.mask,
                        graph.edge_feats)
            vec = emb[center] if retriever.metric == "l2" else desc
            idx = dist = None
            if do_query:
                idx, dist = retriever.rank(vec[None], qp.reshape(1, 4),
                                           top_k, eff)
                idx, dist = idx[0], dist[0]
            if do_insert:
                pos = qp[:3] if insert_pos is None else insert_pos
                retriever.write_rows(insert_at, retriever.encode_rows(
                    vec[None]), pos.reshape(1, 3).to(torch.float32))
        return desc, emb, idx, dist

    return retriever.fused_dispatch(
        step, insert=do_insert,
        exclude_last=context_window - 1 if do_query else 0)
