"""Temporal keyframe graph as padded dense neighbor tensors.

Copied from ``neural_spectral_codec_tpu/keyframe/graph.py:34-173`` (numpy;
the JAX package cannot be imported without importing jax):

    features   (n, d)      node descriptors
    neighbors  (n, D) i32  incoming-neighbor indices (source nodes), padded
    mask       (n, D) bool valid-slot mask
    edge_feats (n, D, 2)   [log1p(dist)/5, angle/π] per edge

``graph_to_tensors`` moves a graph onto a device for the GNN.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class KeyframeGraph(NamedTuple):
    features: np.ndarray    # (n, d) float32
    neighbors: np.ndarray   # (n, D) int32
    mask: np.ndarray        # (n, D) bool
    edge_feats: np.ndarray  # (n, D, 2) float32

    @property
    def n_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def n_edges(self) -> int:
        return int(self.mask.sum())


def _edge_features(poses: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2-D edge features for edges (src→dst):
    [log1p(‖t_src − t_dst‖)/5, geodesic_angle/π]. Copied from JAX
    ``keyframe.graph._edge_features`` (graph.py:53)."""
    d = np.linalg.norm(poses[src][:, :3, 3] - poses[dst][:, :3, 3], axis=1)
    R1 = poses[src][:, :3, :3]
    R2 = poses[dst][:, :3, :3]
    tr = np.einsum("nij,nij->n", R2, R1)  # trace(R2 @ R1^T)
    tr = np.clip(tr, -1.0, 3.0)
    ang = np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))
    return np.stack([np.log1p(d) / 5.0, ang / np.pi], axis=1).astype(np.float32)


def build_graph(
    descriptors: np.ndarray,
    poses: Optional[np.ndarray] = None,
    temporal_neighbors: int = 5,
    loop_closures: Optional[Sequence[Tuple[int, int]]] = None,
    max_loop_per_node: int = 4,
) -> KeyframeGraph:
    """O(n) vectorized graph construction. ``temporal_neighbors`` M gives
    a ±(M//2) window; loop edges are added in both directions and dropped
    whole when either endpoint is full. Copied from JAX
    ``keyframe.graph.build_graph`` (graph.py:69)."""
    n = len(descriptors)
    hw = temporal_neighbors // 2
    D = 2 * hw + max_loop_per_node
    neighbors = np.zeros((n, D), dtype=np.int32)
    mask = np.zeros((n, D), dtype=bool)
    edge_feats = np.zeros((n, D, 2), dtype=np.float32)

    idx = np.arange(n)
    slot = 0
    for off in range(-hw, hw + 1):
        if off == 0:
            continue
        nbr = idx + off
        ok = (nbr >= 0) & (nbr < n)
        neighbors[:, slot] = np.where(ok, nbr, 0)
        mask[:, slot] = ok
        if poses is not None and ok.any():
            edge_feats[ok, slot] = _edge_features(poses, nbr[ok], idx[ok])
        slot += 1

    if loop_closures:
        fill = np.full(n, 2 * hw, dtype=np.int32)  # next free loop slot
        for q, m in loop_closures:
            if not (0 <= q < n and 0 <= m < n) or q == m:
                continue
            if fill[q] >= D or fill[m] >= D:
                continue  # bounded loop degree: keep edges symmetric
            for a, b in ((q, m), (m, q)):
                s = fill[b]
                neighbors[b, s] = a
                mask[b, s] = True
                if poses is not None:
                    edge_feats[b, s] = _edge_features(
                        poses, np.array([a]), np.array([b]))[0]
                fill[b] += 1

    return KeyframeGraph(
        features=np.ascontiguousarray(descriptors, dtype=np.float32),
        neighbors=neighbors,
        mask=mask,
        edge_feats=edge_feats,
    )


def build_graph_from_keyframes(
    keyframes: Sequence,
    temporal_neighbors: int = 5,
    loop_closures: Optional[Sequence[Tuple[int, int]]] = None,
    max_loop_per_node: int = 4,
) -> KeyframeGraph:
    """``build_graph`` over ``Keyframe`` records (their descriptors and
    poses). Copied from JAX ``build_graph_from_keyframes`` (graph.py:127)."""
    desc = np.array([kf.descriptor for kf in keyframes], dtype=np.float32)
    poses = np.array([kf.pose for kf in keyframes])
    return build_graph(desc, poses, temporal_neighbors, loop_closures,
                       max_loop_per_node)


def pad_graph(g: KeyframeGraph, n_slots: int) -> KeyframeGraph:
    """Pad the node axis to ``n_slots`` with isolated nodes (mask all
    False: self-loop-only attention). Eval outputs of the real nodes do not
    change. Copied from JAX ``pad_graph`` (graph.py:142)."""
    n = g.n_nodes
    if n_slots < n:
        raise ValueError(f"n_slots {n_slots} < graph size {n}")
    if n_slots == n:
        return g
    pad = n_slots - n
    return KeyframeGraph(
        features=np.concatenate(
            [g.features, np.zeros((pad, g.features.shape[1]), np.float32)]),
        neighbors=np.concatenate(
            [g.neighbors, np.zeros((pad, g.max_degree), np.int32)]),
        mask=np.concatenate([g.mask, np.zeros((pad, g.max_degree), bool)]),
        edge_feats=np.concatenate(
            [g.edge_feats, np.zeros((pad, g.max_degree,
                                     g.edge_feats.shape[2]), np.float32)]),
    )


def graph_to_coo(g: KeyframeGraph) -> Tuple[np.ndarray, np.ndarray]:
    """Dense → COO: (2, E) edge_index and (E, 2) edge_attr in PyG's
    convention (edge j→i is column [j, i]). Copied from JAX
    ``graph_to_coo`` (graph.py:166)."""
    dst, slot = np.nonzero(g.mask)
    src = g.neighbors[dst, slot]
    return np.stack([src, dst]), g.edge_feats[dst, slot]


def graph_to_tensors(graph: KeyframeGraph, device) -> KeyframeGraph:
    """A copy of the graph as torch tensors on ``device``: float32
    features and edge features, int64 neighbors, bool mask. The copy
    never shares memory with the numpy arrays, so writing a feature row
    (the serving step does) leaves ``graph`` as it was."""
    return KeyframeGraph(
        features=torch.tensor(graph.features, dtype=torch.float32,
                              device=device),
        neighbors=torch.tensor(graph.neighbors, dtype=torch.int64,
                               device=device),
        mask=torch.tensor(graph.mask, dtype=torch.bool, device=device),
        edge_feats=torch.tensor(graph.edge_feats, dtype=torch.float32,
                                device=device),
    )
