"""Temporal keyframe graph as padded dense neighbor tensors.

Copied from ``neural_spectral_codec_tpu/keyframe/graph.py:34-173`` (numpy;
the JAX package cannot be imported without importing jax):

    features   (n, d)      node descriptors
    neighbors  (n, D) i32  incoming-neighbor indices (source nodes), padded
    mask       (n, D) bool valid-slot mask
    edge_feats (n, D, 2)   [log1p(dist)/5, angle/π] per edge

``graph_to_tensors`` moves a graph onto a device for the GNN.
``TemporalGraphManager`` (JAX graph.py:176-473) keeps the online window
in host numpy buffers, updated in place per keyframe.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.keyframe.selector import Keyframe


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


class TemporalGraphManager:
    """Online graph state: a sliding window of active nodes that freezes
    the oldest, loop-closure edge insertion and k-hop neighbourhoods.
    Copied from JAX ``keyframe.graph.TemporalGraphManager``
    (graph.py:176-473), host numpy.

    The dense graph arrays are maintained INCREMENTALLY: adding a keyframe
    touches ≤ M//2 existing rows (the reciprocal temporal edges), freezing
    the oldest node masks ≤ M//2 + loop slots and bumps a base offset — no
    per-event rebuild, no id-dict renumbering. Nodes carry monotonically
    increasing *global* indices internally; window-local indices (what
    :meth:`get_graph` / :meth:`get_node_index` expose) are ``global − start``.
    Amortized O(1) per scan: the backing buffers compact every
    ``max_active_nodes`` freezes.

    One deliberate divergence from :func:`build_graph`: a loop edge dropped
    because an endpoint's loop slots were full stays dropped (the batch
    builder re-evaluates the cap on every rebuild and could resurrect it
    after a freeze frees a slot). The per-node cap is our bounded-degree
    design, not reference behavior, so the simpler monotone rule wins.
    """

    def __init__(self, temporal_neighbors: int = 5, max_active_nodes: int = 1000,
                 feature_dim: int = 800, max_loop_per_node: int = 4,
                 freeze_old_embeddings: bool = True):
        """``freeze_old_embeddings`` (configs keyframe block): when
        False the sliding window never freezes and the active graph grows
        without bound."""
        self.temporal_neighbors = temporal_neighbors
        self.max_active_nodes = max_active_nodes
        self.freeze_old_embeddings = freeze_old_embeddings
        self.feature_dim = feature_dim
        self.max_loop_per_node = max_loop_per_node
        self.keyframes: List[Keyframe] = []
        self.frozen_keyframes: List[Keyframe] = []
        self._frozen_emb: List[np.ndarray] = []
        self._id_to_global = {}
        self._loop_edges: List[Tuple[int, int]] = []  # global index pairs
        self._graph: Optional[KeyframeGraph] = None
        self._hw = temporal_neighbors // 2
        self._D = 2 * self._hw + max_loop_per_node
        self._start = 0      # global index of the first active node
        self._next = 0       # global index of the next node to add
        self._buf_base = 0   # global index of buffer row 0
        self._feat: Optional[np.ndarray] = None  # lazily sized on first add
        self._poses: Optional[np.ndarray] = None
        self._nbr: Optional[np.ndarray] = None
        self._mask: Optional[np.ndarray] = None
        self._ef: Optional[np.ndarray] = None

    def reset(self):
        self.__init__(self.temporal_neighbors, self.max_active_nodes,
                      self.feature_dim, self.max_loop_per_node,
                      self.freeze_old_embeddings)

    @property
    def frozen_embeddings(self) -> Optional[np.ndarray]:
        if not self._frozen_emb:
            return None
        return np.stack(self._frozen_emb)

    @property
    def keyframe_id_to_node_idx(self) -> dict:
        """Window-local view of the id map (kept for introspection; the
        internal map stores stable global indices)."""
        return {k: g - self._start for k, g in self._id_to_global.items()}

    def _row(self, g: int) -> int:
        return g - self._buf_base

    def _ensure_row(self, g: int, dim: int):
        if self._feat is None:
            cap = max(2 * self.max_active_nodes + 2, 64)
            self._feat = np.zeros((cap, dim), np.float32)
            self._poses = np.zeros((cap, 4, 4), np.float64)
            self._nbr = np.zeros((cap, self._D), np.int64)
            self._mask = np.zeros((cap, self._D), bool)
            self._ef = np.zeros((cap, self._D, 2), np.float32)
        if self._row(g) < len(self._feat):
            return
        # compact: rebase the buffers at the window start. Capacity is
        # 2·window+2, so this runs at most once per `window` adds.
        # n_live counts the row being added, which does not exist in the
        # old buffer yet — copy only the rows that do (n_copy).
        n_live = self._next - self._start
        cap = max(len(self._feat), 2 * (n_live + 1))
        s = self._row(self._start)
        n_copy = min(n_live, len(self._feat) - s)
        for name in ("_feat", "_poses", "_nbr", "_mask", "_ef"):
            old = getattr(self, name)
            new = np.zeros((cap,) + old.shape[1:], old.dtype)
            new[:n_copy] = old[s:s + n_copy]
            setattr(self, name, new)
        self._buf_base = self._start

    def add_keyframe(self, keyframe: Keyframe) -> int:
        if keyframe.descriptor is None:
            raise ValueError("Keyframe must have descriptor computed before adding to graph")
        desc = np.asarray(keyframe.descriptor, np.float32)
        g = self._next
        self._next += 1
        self._ensure_row(g, len(desc))
        r = self._row(g)
        self._feat[r] = desc
        self._poses[r] = keyframe.pose
        self._nbr[r] = 0
        self._mask[r] = False
        self._ef[r] = 0.0
        # temporal edges to the previous hw active nodes, both directions.
        # Slot layout matches build_graph: offset −o → slot hw−o,
        # offset +o → slot hw+o−1. Features are symmetric in (src, dst).
        poses2 = np.empty((2, 4, 4))
        for o in range(1, self._hw + 1):
            p = g - o
            if p < self._start:
                break
            rp = self._row(p)
            poses2[0] = self._poses[rp]
            poses2[1] = self._poses[r]
            ef = _edge_features(poses2, np.array([0]), np.array([1]))[0]
            self._nbr[r, self._hw - o] = p
            self._mask[r, self._hw - o] = True
            self._ef[r, self._hw - o] = ef
            self._nbr[rp, self._hw + o - 1] = g
            self._mask[rp, self._hw + o - 1] = True
            self._ef[rp, self._hw + o - 1] = ef
        self.keyframes.append(keyframe)
        self._id_to_global[keyframe.keyframe_id] = g
        self._graph = None
        if (self.freeze_old_embeddings
                and len(self.keyframes) > self.max_active_nodes):
            self._freeze_oldest_node()
        return self._id_to_global[keyframe.keyframe_id] - self._start

    def _freeze_oldest_node(self):
        g0 = self._start
        oldest = self.keyframes.pop(0)
        self.frozen_keyframes.append(oldest)
        del self._id_to_global[oldest.keyframe_id]
        r0 = self._row(g0)
        # successors' backward temporal slots pointing at g0
        for o in range(1, self._hw + 1):
            if g0 + o >= self._next:
                break
            self._mask[self._row(g0 + o), self._hw - o] = False
        # loop edges incident to g0: clear the mirror slot on the survivor
        for s in range(2 * self._hw, self._D):
            if not self._mask[r0, s]:
                continue
            rj = self._row(int(self._nbr[r0, s]))
            for sj in range(2 * self._hw, self._D):
                if self._mask[rj, sj] and self._nbr[rj, sj] == g0:
                    self._mask[rj, sj] = False
                    break
        self._mask[r0] = False
        if any(g0 in e for e in self._loop_edges):
            self._loop_edges = [e for e in self._loop_edges if g0 not in e]
        if oldest.embedding is not None:
            self._frozen_emb.append(np.asarray(oldest.embedding))
        self._start += 1
        self._graph = None

    def add_loop_closure_edge(self, query_keyframe_id: int, match_keyframe_id: int,
                              pose_query: Optional[np.ndarray] = None,
                              pose_match: Optional[np.ndarray] = None) -> bool:
        gq = self._id_to_global.get(query_keyframe_id)
        gm = self._id_to_global.get(match_keyframe_id)
        if gq is None or gm is None or not self.keyframes:
            return False
        if gq == gm:
            return True  # degenerate self-edge: accepted, never materialized
        rq, rm = self._row(gq), self._row(gm)

        def free_slot(row):
            for s in range(2 * self._hw, self._D):
                if not self._mask[row, s]:
                    return s
            return None

        sq, sm = free_slot(rq), free_slot(rm)
        if sq is None or sm is None:
            return True  # bounded loop degree: drop the whole edge
        poses2 = np.stack([self._poses[rq], self._poses[rm]])
        ef = _edge_features(poses2, np.array([0]), np.array([1]))[0]
        self._nbr[rq, sq] = gm
        self._mask[rq, sq] = True
        self._ef[rq, sq] = ef
        self._nbr[rm, sm] = gq
        self._mask[rm, sm] = True
        self._ef[rm, sm] = ef
        self._loop_edges.append((gq, gm))
        self._graph = None
        return True

    def get_graph(self) -> Optional[KeyframeGraph]:
        if not self.keyframes:
            return None
        if self._graph is None:
            s, e = self._row(self._start), self._row(self._next)
            mask = self._mask[s:e].copy()
            nbr = np.where(mask, self._nbr[s:e] - self._start,
                           0).astype(np.int32)
            # feature rows never mutate after add and compaction swaps in a
            # fresh buffer (old views stay valid), so a read-only view
            # avoids an O(window·dim) copy per read
            feats = self._feat[s:e]
            feats.setflags(write=False)
            self._graph = KeyframeGraph(
                features=feats,
                neighbors=nbr,
                mask=mask,
                edge_feats=np.where(mask[..., None], self._ef[s:e], 0.0),
            )
        return self._graph

    def get_node_index(self, keyframe_id: int) -> Optional[int]:
        g = self._id_to_global.get(keyframe_id)
        return None if g is None else g - self._start

    def get_k_hop_neighbors(self, node_idx: int, k: int) -> Set[int]:
        g = self.get_graph()
        if g is None or k <= 0:
            return {node_idx}
        out = {node_idx}
        frontier = {node_idx}
        for _ in range(k):
            nxt = set()
            for v in frontier:
                nxt.update(g.neighbors[v][g.mask[v]].tolist())
            nxt -= out
            out |= nxt
            frontier = nxt
            if not frontier:
                break
        return out

    def get_local_subgraph(self, node_idx: int, k_hops: int = 3):
        """k-hop subgraph and its {window index: subgraph index} mapping,
        for the local refresh of ``models.gnn.LocalUpdateGNN``."""
        g = self.get_graph()
        if g is None:
            raise ValueError("Graph is empty")
        nodes = sorted(self.get_k_hop_neighbors(node_idx, k_hops))
        mapping = {old: new for new, old in enumerate(nodes)}
        sel = np.asarray(nodes)
        in_set = np.zeros(g.n_nodes, dtype=bool)
        in_set[sel] = True
        remap = np.zeros(g.n_nodes, dtype=np.int32)
        remap[sel] = np.arange(len(sel), dtype=np.int32)
        sub_mask = g.mask[sel] & in_set[g.neighbors[sel]]
        sub_neighbors = np.where(sub_mask, remap[g.neighbors[sel]], 0)
        sub = KeyframeGraph(
            features=g.features[sel],
            neighbors=sub_neighbors.astype(np.int32),
            mask=sub_mask,
            edge_feats=np.where(sub_mask[..., None], g.edge_feats[sel], 0.0),
        )
        return sub, mapping

    def set_node_features(self, node_idx: int, desc: np.ndarray) -> None:
        """Overwrite one node's feature row (window-local index): the
        serving step adds the keyframe with a placeholder descriptor and
        fills in the one computed on the device."""
        g = node_idx + self._start
        self._feat[self._row(g)] = np.asarray(desc, np.float32)
        self.keyframes[node_idx].descriptor = np.asarray(desc, np.float32)
        self._graph = None

    def update_embeddings(self, embeddings: np.ndarray):
        if len(embeddings) != len(self.keyframes):
            raise ValueError(
                f"Embedding count ({len(embeddings)}) != keyframe count ({len(self.keyframes)})"
            )
        for kf, e in zip(self.keyframes, np.asarray(embeddings)):
            kf.embedding = e

    def get_all_keyframes(self) -> List[Keyframe]:
        return self.frozen_keyframes + self.keyframes

    def get_all_descriptors(self) -> np.ndarray:
        return np.array([kf.descriptor for kf in self.get_all_keyframes()])

    def get_all_embeddings(self) -> Optional[np.ndarray]:
        kfs = self.get_all_keyframes()
        if not kfs or kfs[0].embedding is None:
            return None
        return np.array([kf.embedding for kf in kfs])

    def get_statistics(self) -> dict:
        g = self.get_graph()
        n_active = len(self.keyframes)
        n_edges = g.n_edges if g is not None else 0
        return {
            "num_active_nodes": n_active,
            "num_frozen_nodes": len(self.frozen_keyframes),
            "total_nodes": n_active + len(self.frozen_keyframes),
            "num_edges": n_edges,
            "avg_degree": n_edges / n_active if n_active else 0.0,
        }
