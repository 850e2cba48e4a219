"""Sharded GNN training and eval steps.

Port of ``neural_spectral_codec_tpu/parallel/train.py`` for one
controller over a ``Mesh``:

  * **DP**: every device holds the whole graph and runs the full-graph
    train forward on it, with differentiable replicas of the master
    parameters and a dropout generator in the same state, so every
    replica draws the same masks (one graph, as in JAX, where the
    replicated forward is one computation). The triplet batch is split
    into one slab per device; each device takes its slab's masked loss
    sum over the global count of valid triplets, and the backward of the
    sum of those losses accumulates every replica's gradient into the
    master parameters (JAX's gradient ``psum``). The BatchNorm running
    statistics are updated once, by the first replica.
  * **Node sharding**: the graph's nodes are cut into contiguous slabs,
    one per device (``SpectralGNN.forward_slabs``): the (n_slab, D+1, C)
    neighbour tensors, the attention and the Dense outputs stay on their
    slab's device; each layer's (n, C) transform is all-gathered for the
    neighbour gather; BatchNorm takes the statistics of all slabs. The
    embeddings are gathered on ``mesh.devices[0]``, where the triplet
    loss runs. Slabs may differ by one node, so any node count shards
    and the loss equals the single-device one.

Then the global-norm clip and one Adam step on the master parameters, as
``training.trainer.train_step`` does.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from neural_spectral_codec_torch.keyframe.graph import (
    KeyframeGraph, graph_to_tensors)
from neural_spectral_codec_torch.models.gnn import SpectralGNN
from neural_spectral_codec_torch.parallel.mesh import (
    Mesh, all_gather, data_sharding, replicate)
from neural_spectral_codec_torch.training.loss import (
    triplet_loss, triplet_terms)
from neural_spectral_codec_torch.training.trainer import (
    clip_by_global_norm_)


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


def place_graph(graph: KeyframeGraph, mesh: Mesh,
                shard_nodes: bool) -> List[KeyframeGraph]:
    """A numpy graph as tensors on the mesh: one contiguous node slab per
    device (neighbour indices stay global) with ``shard_nodes``, else one
    replica per device."""
    if not shard_nodes:
        return replicate(graph_to_tensors(graph, mesh.devices[0]), mesh)
    cuts = np.array_split(np.arange(graph.n_nodes), mesh.size)
    return [graph_to_tensors(KeyframeGraph(*(a[c[0]:c[-1] + 1] if len(c)
                                             else a[:0] for a in graph)), d)
            for c, d in zip(cuts, mesh.devices)]


def _slabs(placed: List[KeyframeGraph]) -> tuple:
    return tuple(list(field) for field in zip(*placed))


def make_sharded_train_step(model: SpectralGNN,
                            optimizer: torch.optim.Optimizer, mesh: Mesh,
                            shard_nodes: bool = False,
                            normalize: bool = False,
                            grad_clip: Optional[float] = 1.0) -> Callable:
    """A train step over ``mesh`` for ``model``, whose parameters live on
    ``mesh.devices[0]``.

    Returns ``step(placed, anchor_idx, pos_idx, neg_idx, triplet_mask,
    margin, generator=None) -> loss`` (a 0-d tensor on
    ``mesh.devices[0]``): ``placed`` from ``place_graph`` with the same
    ``shard_nodes``; the triplet tensors' length must divide by the mesh
    size (``pad_to_multiple``). ``generator`` draws the dropout masks and
    must be given when the model drops out under DP. ``normalize`` must
    match the trainer's ``normalize_embeddings``."""
    dev0 = mesh.devices[0]
    generators = {}

    def replica_generator(generator, device, state):
        if generator.device == device:
            g = generator
        else:
            g = generators.setdefault(device, torch.Generator(device=device))
        g.set_state(state)
        return g

    def dp_loss(placed, triplets, count, margin, generator):
        if generator is None and model.dropout > 0:
            raise ValueError("a data-parallel step with dropout needs a "
                             "generator: every replica draws the same masks")
        state = None if generator is None else generator.get_state()
        names = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        total = 0.0
        for k, (dev, sl) in enumerate(data_sharding(mesh,
                                                    triplets.shape[0])):
            g = placed[k]
            gen = (None if generator is None
                   else replica_generator(generator, dev, state))
            args = (g.features, g.neighbors, g.mask, g.edge_feats)
            if k == 0:
                emb = model(*args, generator=gen)
            else:   # a replica: its own copy of the running statistics
                variables = {n: p.to(dev) for n, p in names.items()}
                variables.update({n: b.to(dev).clone()
                                  for n, b in buffers.items()})
                emb = functional_call(model, variables, args,
                                      {"generator": gen})
            t = triplets[sl].to(dev)
            per = triplet_terms(*(emb.index_select(0, t[:, j])
                                  for j in range(3)), margin, normalize)
            total = total + ((per * t[:, 3].to(per.dtype)).sum()
                             / count.to(dev)).to(dev0)
        return total

    def node_loss(placed, triplets, count, margin, generator):
        emb, _ = model.forward_slabs(*_slabs(placed), generator=generator)
        emb = all_gather(emb, dev0)
        t = triplets.to(dev0)
        return triplet_loss(*(emb.index_select(0, t[:, j]) for j in range(3)),
                            margin=margin, mask=t[:, 3].bool(),
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
    ``mesh.devices[0]``: the node-sharded forward with ``shard_nodes``,
    else the forward on the first replica (every replica would compute
    the same)."""
    def eval_step(placed: List[KeyframeGraph]) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            if shard_nodes:
                emb, _ = model.forward_slabs(*_slabs(placed))
                return all_gather(emb, mesh.devices[0])
            g = placed[0]
            return model(g.features, g.neighbors, g.mask, g.edge_feats)
    return eval_step
