"""Sharded GNN training and eval steps.

Port of ``neural_spectral_codec_tpu/parallel/train.py`` for one
controller over a ``Mesh``:

  * **DP**: every device holds the whole graph and runs the full-graph
    train forward on it, with differentiable replicas of the master
    parameters. The first replica draws the dropout masks and the others
    take the same masks back (``gnn.KeepDraws``), so every replica drops
    what one graph drops (as in JAX, where the replicated forward is one
    computation) and the generator advances once a step. The triplet
    batch is split into one slab per device; each device takes its
    slab's masked loss sum over the global count of valid triplets, and
    the backward of the sum of those losses accumulates every replica's
    gradient into the master parameters (JAX's gradient ``psum``). The
    BatchNorm running statistics are updated once, by the first replica.
  * **Node sharding**: the graph's nodes are cut into contiguous slabs,
    one per device (``SpectralGNN.forward_slabs``): the (n_slab, D+1, C)
    neighbour tensors, the attention and the Dense outputs stay on their
    slab's device; each layer's (n, C) transform is all-gathered for the
    neighbour gather; BatchNorm takes the statistics of all slabs. The
    embeddings are gathered on ``mesh.devices[0]``, where the triplet
    loss runs. Slabs may differ by one node, so any node count shards
    and the loss equals the single-device one.

The triplet rows are gathered by ``models.gather_kernel.gather_rows``,
whose backward is kernel G (ordered sums, no atomics; padded triplets are
left out of its segments), as in the single-device step; then the
global-norm clip and one Adam step on the master parameters, as
``training.trainer.train_step`` does. So a sharded step gives the same
bits run to run.

JAX compiles each program into one dispatch. Here, on a mesh whose
shards all sit on one device (``Mesh.one_device``: ``Mesh([cuda:0] *
4)``, the only mesh of a one-card machine, and the CPU test meshes),
each is an executable (``utils/graph_exec.GraphStep``), on a card one
captured CUDA graph replayed step after step:
``ShardedTrainStepExecutable`` (the graph in a device arena, loaded once
a run, the slabs or replicas views of it; each step's triplets and mask
staged, the loss out; forward, gathers, loss, backward, clip and Adam in
one graph of the train pool) and ``ShardedEvalExecutable`` (the padded
graph staged, the embeddings fetched; the eval pool). A mesh over
distinct cards spans several devices' streams, which no one graph holds:
there the programs run op by op (declared, not a fallback; no machine
with two cards has run it). ``make_sharded_train_step`` and
``make_sharded_eval_step`` are those op-by-op programs: each call of
theirs, on any mesh, is counted in ``trainer.STATS["sharded_op_by_op"]``
and ``gnn.STATS["sharded_op_by_op"]``; the executables run the same
steps uncounted.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from neural_spectral_codec_torch.keyframe.graph import (
    KeyframeGraph, graph_to_tensors)
from neural_spectral_codec_torch.models import gnn
from neural_spectral_codec_torch.models.gather_kernel import gather_rows
from neural_spectral_codec_torch.models.gnn import (
    EvalExecutable, KeepDraws, SpectralGNN)
from neural_spectral_codec_torch.parallel.mesh import (
    Mesh, all_gather, data_sharding, replicate)
from neural_spectral_codec_torch.training import trainer
from neural_spectral_codec_torch.training.loss import (
    triplet_loss, triplet_terms)
from neural_spectral_codec_torch.training.trainer import (
    TrainStepExecutable, clip_by_global_norm_)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ``arr`` along ``axis`` to a multiple of ``multiple``. Returns
    (padded, valid_mask_along_axis)."""
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    mask = np.zeros(target, bool)
    mask[:n] = True
    if target == n:
        return arr, mask
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(arr, widths, constant_values=fill), mask


def _cut(graph: KeyframeGraph, n_slabs: int) -> List[KeyframeGraph]:
    """``n_slabs`` contiguous node slabs of ``graph`` (numpy arrays or
    tensors; views), differing by one node at most; neighbour indices
    stay global."""
    cuts = np.array_split(np.arange(graph.n_nodes), n_slabs)
    return [KeyframeGraph(*(a[c[0]:c[-1] + 1] if len(c) else a[:0]
                            for a in graph)) for c in cuts]


def place_graph(graph: KeyframeGraph, mesh: Mesh,
                shard_nodes: bool) -> List[KeyframeGraph]:
    """A numpy graph as tensors on the mesh: one contiguous node slab per
    device (neighbour indices stay global) with ``shard_nodes``, else one
    replica per device."""
    if not shard_nodes:
        return replicate(graph_to_tensors(graph, mesh.devices[0]), mesh)
    return [graph_to_tensors(slab, d)
            for slab, d in zip(_cut(graph, mesh.size), mesh.devices)]


def _placed_views(sections: dict, mesh: Mesh,
                  shard_nodes: bool) -> List[KeyframeGraph]:
    """``place_graph``'s layout on a one-device mesh as views of an
    arena's graph sections: its node slabs, or the whole graph for every
    replica."""
    graph = KeyframeGraph(*(sections[f] for f in KeyframeGraph._fields))
    return _cut(graph, mesh.size) if shard_nodes else [graph] * mesh.size


def _slabs(placed: List[KeyframeGraph]) -> tuple:
    return tuple(list(field) for field in zip(*placed))


def make_sharded_train_step(model: SpectralGNN,
                            optimizer: torch.optim.Optimizer, mesh: Mesh,
                            shard_nodes: bool = False,
                            normalize: bool = False,
                            grad_clip: Optional[float] = 1.0) -> Callable:
    """A train step over ``mesh`` for ``model``, whose parameters live on
    ``mesh.devices[0]``, run op by op (``ShardedTrainStepExecutable``
    holds the same step as one static step).

    Returns ``step(placed, anchor_idx, pos_idx, neg_idx, triplet_mask,
    margin, generator=None) -> loss`` (a 0-d tensor on
    ``mesh.devices[0]``): ``placed`` from ``place_graph`` with the same
    ``shard_nodes``; the triplet tensors' length must divide by the mesh
    size (``pad_to_multiple``). ``generator`` draws the dropout masks
    (the device's global generator when None). ``normalize`` must match
    the trainer's ``normalize_embeddings``. Static shapes and no host
    synchronisation. Each call is counted in
    ``trainer.STATS["sharded_op_by_op"]``."""
    step = _train_step(model, optimizer, mesh, shard_nodes, normalize,
                       grad_clip)

    def counted(*args, **kwargs) -> torch.Tensor:
        trainer.STATS["sharded_op_by_op"] += 1
        return step(*args, **kwargs)

    return counted


def _train_step(model: SpectralGNN, optimizer: torch.optim.Optimizer,
                mesh: Mesh, shard_nodes: bool, normalize: bool,
                grad_clip: Optional[float]) -> Callable:
    """``make_sharded_train_step``'s step, uncounted."""
    dev0 = mesh.devices[0]

    def rows(emb, t):
        """The anchor, positive and negative rows of ``t`` (columns
        anchor, positive, negative, valid) and the valid mask: the
        gathers' backward is kernel G, padded triplets (a zero gradient)
        out of its segments."""
        valid = t[:, 3].bool()
        return [gather_rows(emb, t[:, j], valid=valid)
                for j in range(3)], valid

    def dp_loss(placed, triplets, count, margin, generator):
        names = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        draws = KeepDraws()
        total = 0.0
        for k, (dev, sl) in enumerate(data_sharding(mesh,
                                                    triplets.shape[0])):
            g = placed[k]
            args = (g.features, g.neighbors, g.mask, g.edge_feats)
            if k == 0:
                emb = model(*args, generator=generator, draws=draws)
            else:   # a replica: its own copy of the running statistics
                variables = {n: p.to(dev) for n, p in names.items()}
                variables.update({n: b.to(dev).clone()
                                  for n, b in buffers.items()})
                emb = functional_call(model, variables, args,
                                      {"draws": draws.replay()})
            (a, p, n), valid = rows(emb, triplets[sl].to(dev))
            per = triplet_terms(a, p, n, margin, normalize)
            total = total + ((per * valid.to(per.dtype)).sum()
                             / count.to(dev)).to(dev0)
        return total

    def node_loss(placed, triplets, count, margin, generator):
        emb, _ = model.forward_slabs(*_slabs(placed), generator=generator)
        emb = all_gather(emb, dev0)
        (a, p, n), valid = rows(emb, triplets.to(dev0))
        return triplet_loss(a, p, n, margin=margin, mask=valid,
                            normalize=normalize)

    loss_fn = node_loss if shard_nodes else dp_loss

    def step(placed: List[KeyframeGraph], anchor_idx: torch.Tensor,
             pos_idx: torch.Tensor, neg_idx: torch.Tensor,
             triplet_mask: torch.Tensor, margin: float,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        triplets = torch.stack([anchor_idx, pos_idx, neg_idx,
                                triplet_mask.to(anchor_idx.dtype)], dim=1)
        count = triplet_mask.to(dev0).float().sum().clamp(min=1.0)
        loss = loss_fn(placed, triplets, count, margin, generator)
        loss.backward()
        if grad_clip:
            clip_by_global_norm_(list(model.parameters()), grad_clip)
        optimizer.step()
        return loss.detach()

    return step


def make_sharded_eval_step(model: SpectralGNN, mesh: Mesh,
                           shard_nodes: bool = True) -> Callable:
    """``fn(placed) -> (n, output_dim)`` eval embeddings on
    ``mesh.devices[0]``, op by op: the node-sharded forward with
    ``shard_nodes``, else the forward on the first replica (every replica
    would compute the same). Each call is counted in
    ``gnn.STATS["sharded_op_by_op"]`` (``ShardedEvalExecutable`` runs the
    same forward uncounted)."""
    step = _eval_step(model, mesh, shard_nodes)

    def counted(placed: List[KeyframeGraph]) -> torch.Tensor:
        gnn.STATS["sharded_op_by_op"] += 1
        return step(placed)

    return counted


def _eval_step(model: SpectralGNN, mesh: Mesh, shard_nodes: bool
               ) -> Callable:
    """``make_sharded_eval_step``'s forward, uncounted."""
    def eval_step(placed: List[KeyframeGraph]) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            if shard_nodes:
                emb, _ = model.forward_slabs(*_slabs(placed))
                return all_gather(emb, mesh.devices[0])
            g = placed[0]
            return model(g.features, g.neighbors, g.mask, g.edge_feats)
    return eval_step


def _one_device(mesh: Mesh) -> torch.device:
    if not mesh.one_device:
        raise ValueError(f"{mesh} spans distinct devices: its sharded "
                         f"programs run op by op (make_sharded_train_step, "
                         f"make_sharded_eval_step)")
    return mesh.devices[0]


class ShardedTrainStepExecutable(TrainStepExecutable):
    """JAX's jitted ``make_sharded_train_step`` (parallel/train.py:98) on a
    one-device mesh, for one (model, optimizer, mesh, DP or node-sharded,
    n nodes, degree, edge width, B triplets, margin, clip, normalize):
    ``TrainStepExecutable``'s arenas, loading and staging (the graph in
    ``graph_data`` once a run; each step's (B, 3) triplets and (B,) mask;
    the loss out), its train pool and counts, with
    ``make_sharded_train_step``'s step over views of the arena (the node
    slabs, or the whole graph for each replica) as its step. On a card
    with ``use_graph`` one captured CUDA graph; its census must hold
    G's nodes for every gather: each replica's n_layers GAT gathers and
    3 triplet gathers under DP, n_layers a slab and 3 triplet gathers
    node-sharded."""

    def __init__(self, model: SpectralGNN, optimizer: torch.optim.Optimizer,
                 mesh: Mesh, shard_nodes: bool, n_nodes: int, degree: int,
                 edge_dim: int, batch: int, margin: float,
                 grad_clip: Optional[float], normalize: bool,
                 generator: Optional[torch.Generator],
                 use_graph: bool = True):
        if batch % mesh.size:
            raise ValueError(f"{batch} triplets do not divide over "
                             f"{mesh.size} shards (pad_to_multiple)")
        super().__init__(model, optimizer, n_nodes, degree, edge_dim, batch,
                         margin, grad_clip, normalize, generator,
                         _one_device(mesh), use_graph)
        self.mesh, self.shard_nodes = mesh, shard_nodes
        self._sharded = _train_step(model, optimizer, mesh, shard_nodes,
                                    normalize, grad_clip)
        self._placed = _placed_views(self.graph_data.dev, mesh, shard_nodes)

    def gathers(self) -> int:
        layers, size = self.model.n_layers, self.mesh.size
        return (layers * size + 3 if self.shard_nodes
                else size * (layers + 3))

    def _step(self) -> None:
        i = self.inputs.dev
        t = i["triplets"]
        loss = self._sharded(self._placed, t[:, 0], t[:, 1], t[:, 2],
                             i["tmask"], self.margin, self.generator)
        self.outputs.dev["loss"].copy_(loss)


class ShardedEvalExecutable(EvalExecutable):
    """JAX's jitted ``make_sharded_eval_step`` (parallel/train.py:121) on
    a one-device mesh, for one (model, mesh, node-sharded or not, n
    nodes, degree, edge width): ``gnn.EvalExecutable``'s arenas (the
    graph's four arrays staged with one upload, the (n, output_dim)
    embeddings fetched with one download) and eval pool, with
    ``make_sharded_eval_step`` over views of the staged graph as its
    step. ``n_nodes`` is the graph padded to a multiple of the mesh size
    (``keyframe.graph.pad_graph``)."""

    def __init__(self, model: SpectralGNN, mesh: Mesh, shard_nodes: bool,
                 n_nodes: int, degree: int, edge_dim: int,
                 use_graph: bool = True):
        super().__init__(model, n_nodes, degree, edge_dim, _one_device(mesh),
                         use_graph)
        self._eval = _eval_step(model, mesh, shard_nodes)
        self._placed = _placed_views(self.inputs.dev, mesh, shard_nodes)

    def _step(self) -> None:
        self.outputs.dev["emb"].copy_(self._eval(self._placed))
