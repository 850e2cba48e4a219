"""Spectral GNN: edge-conditioned GAT as dense masked attention.

Port of ``neural_spectral_codec_tpu/models/gnn.py:37-182`` (and
``gnn_forward``, :297, and ``LocalUpdateGNN``, :311):

    Input(800) → Linear(256) + BatchNorm + ReLU
      → n_layers × [GAT(256, heads=1, edge_dim=2) → BatchNorm
                    (+ReLU+dropout except last layer; +x_prev residual
                     for middle layers)]
      → Linear(800) (+ input residual; projection if dims differ)

The GAT follows PyG ``GATConv(heads=1, concat=False)``: a shared linear
transform without bias, logits a_src·Wx_j + a_dst·Wx_i + a_edge·(W_e e_ji),
LeakyReLU(0.2), a masked softmax over the incoming edges of i, and a
self-loop in the LAST slot whose edge feature is the mean of the node's
valid incoming edge features. Graphs are the padded dense neighbor
tensors of ``keyframe/graph.py``.

Train mode follows Flax: BatchNorm normalises with the biased batch
variance and averages the biased variance into ``running_var``
(``FlaxBatchNorm1d``), and the GAT returns its attention after dropout.
Dropout draws from an optional ``torch.Generator`` passed to ``forward``.

State names differ from Flax's; ``models/convert.py`` maps Flax
parameters onto this module.
"""

from __future__ import annotations

import math
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neural_spectral_codec_torch.keyframe.graph import (
    KeyframeGraph, pad_graph)
from neural_spectral_codec_torch.models.gather_kernel import gather_rows
from neural_spectral_codec_torch.utils.graph_exec import (
    Arena, ExecutableCache, GraphStep, SharedPool)


def _glorot_(t: torch.Tensor, fan_in: int, fan_out: int,
             generator: Optional[torch.Generator]) -> None:
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-lim, lim, generator=generator)


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        t.normal_(0.0, math.sqrt(1.0 / fan_in), generator=generator)


class KeepDraws:
    """The dropout keep masks of one train forward, in the order it draws
    them. A forward given an empty ``KeepDraws`` draws and records each
    mask; one given its ``replay()`` takes them back in that order and
    draws nothing. So data-parallel replicas drop what the first replica
    dropped and the generator advances once a step, with no host-side
    generator state, which a CUDA graph could not hold."""

    def __init__(self, masks: Optional[List[torch.Tensor]] = None):
        self.masks = [] if masks is None else masks
        self._replaying = masks is not None
        self._next = 0

    def replay(self) -> "KeepDraws":
        return KeepDraws(self.masks)

    def take(self, shape: tuple, p: float, device: torch.device,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        if self._replaying:
            self._next += 1
            return self.masks[self._next - 1]
        keep = torch.rand(shape, generator=generator, device=device) >= p
        self.masks.append(keep)
        return keep


def _keep_masks(sizes: Sequence[int], devices: Sequence[torch.device],
                width: int, p: float, training: bool,
                generator: Optional[torch.Generator],
                draws: Optional[KeepDraws] = None
                ) -> Optional[List[torch.Tensor]]:
    """Flax ``nn.Dropout``'s keep masks (keep with probability 1 − p) for
    node slabs of ``sizes`` rows on ``devices``, or None when nothing is
    dropped. One (Σ sizes, width) draw on the first slab's device from
    ``generator`` (the global generator when None), cut into the slabs'
    rows: slabs draw the bits one graph would draw. ``draws`` records the
    draw, or hands back a recorded one instead."""
    if not training or p == 0.0:
        return None
    keep = (KeepDraws() if draws is None else draws).take(
        (sum(sizes), width), p, devices[0], generator)
    return [k.to(d) for k, d in zip(keep.split(list(sizes)), devices)]


def _dropped(x: torch.Tensor, keep: Optional[torch.Tensor],
             p: float) -> torch.Tensor:
    """Kept entries scaled by 1/(1 − p), dropped ones 0."""
    return x if keep is None else torch.where(keep, x / (1.0 - p), 0.0)


def _on(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` on ``like``'s device: a parameter's replica (differentiable;
    the parameter itself where it already lives there)."""
    return t.to(like.device)


def _dense(lin: nn.Linear, x: torch.Tensor,
           dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=dtype)``: input, kernel and bias cast to
    ``dtype``, the product rounded to it, then the bias added in it
    (float32 accumulation inside the product). ``dtype`` None: float32."""
    w, b = _on(lin.weight, x), _on(lin.bias, x)
    if dtype is None:
        return F.linear(x, w, b)
    return F.linear(x.to(dtype), w.to(dtype)) + b.to(dtype)


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with Flax's train mode: normalise with the
    biased batch variance and average that same biased variance (not the
    unbiased one PyTorch uses) into ``running_var``. The variance is
    Flax's one-pass E[x²] − E[x]², clamped at 0. Where a feature's mean
    is far above its spread that formula cancels, and the train forward
    of either framework is then only good to about 1e-4. PyTorch momentum
    0.1 is Flax momentum 0.9. Eval mode is PyTorch's, which is Flax's.
    Input of another type (bf16) is normalised in float32, as Flax's
    ``BatchNorm(dtype=float32)`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=0)
        var = ((x * x).mean(dim=0) - mean * mean).clamp(min=0.0)
        return self._train_normalize([x], mean, var)[0]

    def _train_normalize(self, xs: List[torch.Tensor], mean: torch.Tensor,
                         var: torch.Tensor) -> List[torch.Tensor]:
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        # Flax's order: y = (x − mean) · (rsqrt(var + eps) · scale) + bias
        scale = torch.rsqrt(var + self.eps) * self.weight
        return [(x - _on(mean, x)) * _on(scale, x) + _on(self.bias, x)
                for x in xs]

    def forward_slabs(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The same over node slabs (one device each): train mode takes
        the statistics of all slabs together, their sums gathered on the
        module's device, and updates the running statistics once."""
        if len(xs) == 1:
            return [self(xs[0])]
        xs = [x.float() for x in xs]
        if not self.training:
            return [F.batch_norm(x, _on(self.running_mean, x),
                                 _on(self.running_var, x),
                                 _on(self.weight, x), _on(self.bias, x),
                                 False, 0.0, self.eps) for x in xs]
        dev = self.weight.device
        n = sum(x.shape[0] for x in xs)
        mean = sum(x.sum(dim=0).to(dev) for x in xs) / n
        sq = sum((x * x).sum(dim=0).to(dev) for x in xs) / n
        return self._train_normalize(xs, mean,
                                     (sq - mean * mean).clamp(min=0.0))


class EdgeGATLayer(nn.Module):
    """Single-head GAT with optional edge conditioning over padded dense
    neighbors. ``forward`` returns (out, attention); attention is (n, D+1)
    with the self-loop in the last slot.

    ``compute_dtype`` (JAX ``EdgeGATLayer.compute_dtype``): None computes
    in float32; bf16 casts the input and weights, rounds the transform,
    the attention projections and the edge terms to bf16 and takes the
    logits in float32; the softmax and its masking stay float32, and the
    value sum takes the attention rounded to bf16 against the bf16 values
    with a float32 sum (JAX's ``preferred_element_type=float32``), exact
    products of bf16 values summed in float32."""

    def __init__(self, in_features: int, features: int,
                 edge_dim: Optional[int] = 2, negative_slope: float = 0.2,
                 attn_dropout: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.attn_dropout = attn_dropout
        self.compute_dtype = compute_dtype
        self.lin = nn.Linear(in_features, features, bias=False)
        self.att_src = nn.Parameter(torch.empty(features))
        self.att_dst = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.zeros(features))
        if edge_dim is not None:
            self.lin_edge = nn.Linear(edge_dim, features, bias=False)
            self.att_edge = nn.Parameter(torch.empty(features))
        else:
            self.lin_edge = None
            self.att_edge = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initialisers: Glorot-uniform weights, zero bias."""
        c, n_in = self.lin.weight.shape
        _glorot_(self.lin.weight, n_in, c, generator)
        for att in (self.att_src, self.att_dst):
            _glorot_(att, 1, c, generator)
        if self.lin_edge is not None:
            _glorot_(self.lin_edge.weight, self.lin_edge.weight.shape[1], c,
                     generator)
            _glorot_(self.att_edge, 1, c, generator)
        with torch.no_grad():
            self.bias.zero_()

    def _c(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.compute_dtype is None else t.to(self.compute_dtype)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """h = x W (no bias), on ``x``'s device, in the compute dtype."""
        return F.linear(self._c(x), self._c(_on(self.lin.weight, x)))

    def attend(self, h: torch.Tensor, h_all: torch.Tensor,
               neighbors: torch.Tensor, mask: torch.Tensor,
               edge_feats: Optional[torch.Tensor],
               keep: Optional[torch.Tensor] = None):
        """(out, attention) of the nodes whose transforms are ``h``;
        ``neighbors`` index ``h_all``, every node's transform on ``h``'s
        device (``h`` itself on one device). ``keep`` is the attention's
        dropout mask (``_keep_masks``)."""
        n = neighbors.shape[0]
        c, f32 = self._c, (lambda t: t.to(torch.float32))
        att_src, att_dst = c(_on(self.att_src, h)), c(_on(self.att_dst, h))
        # gather_rows, not h_all[neighbors]: advanced indexing's backward
        # sorts the indices (94% of a train step's device time at 20,000
        # nodes on an H100) and index_select's adds with atomics; its
        # backward is kernel G over the valid slots' segment table
        h_nbr = gather_rows(h_all, neighbors.reshape(-1),
                            valid=mask.reshape(-1)).view(
            *neighbors.shape, -1)                        # (n, D, C)
        a_dst = f32(h @ att_dst)                         # (n,)
        logits = f32(h_nbr @ att_src) + a_dst[:, None]   # (n, D)
        self_logit = f32(h @ att_src) + a_dst            # (n,)
        if self.lin_edge is not None and edge_feats is not None:
            w_e = c(_on(self.lin_edge.weight, h))
            att_e = c(_on(self.att_edge, h))
            ef = c(edge_feats)
            logits = logits + f32(F.linear(ef, w_e) @ att_e)
            # self-loop edge feature = mean of the valid incoming edge
            # features (zeros for an isolated node), PyG fill_value='mean'
            cnt = mask.sum(dim=1, keepdim=True).clamp(min=1)
            mean_ef = torch.where(mask[..., None], ef, 0.0).sum(dim=1) / cnt
            self_logit = self_logit + f32(F.linear(mean_ef, w_e) @ att_e)
        all_logits = torch.cat([logits, self_logit[:, None]], dim=1)
        all_logits = F.leaky_relu(all_logits, self.negative_slope)
        full_mask = torch.cat(
            [mask, torch.ones((n, 1), dtype=torch.bool, device=mask.device)],
            dim=1)
        all_logits = all_logits.masked_fill(~full_mask, -math.inf)
        alpha = _dropped(torch.softmax(all_logits, dim=1), keep,
                         self.attn_dropout)
        vals = torch.cat([h_nbr, h[:, None, :]], dim=1)  # (n, D+1, C)
        if self.compute_dtype is None:
            out = torch.einsum("nd,ndc->nc", alpha, vals)
        else:
            out = torch.einsum("nd,ndc->nc", f32(c(alpha)), f32(vals))
        return out + _on(self.bias, h), alpha

    def forward(self, x: torch.Tensor, neighbors: torch.Tensor,
                mask: torch.Tensor, edge_feats: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        h = self.transform(x)
        keep = _keep_masks([x.shape[0]], [x.device], neighbors.shape[1] + 1,
                           self.attn_dropout, self.training, generator)
        return self.attend(h, h, neighbors, mask, edge_feats,
                           None if keep is None else keep[0])


class SpectralGNN(nn.Module):
    """Full enhancement network (JAX ``SpectralGNN``). BatchNorm uses
    eps 1e-5 and PyTorch momentum 0.1 (Flax momentum 0.9); in eval mode
    it normalises with the running statistics, in train mode as Flax
    does (``FlaxBatchNorm1d``).

    ``compute_dtype`` (JAX ``SpectralGNN.compute_dtype``): None is float32
    throughout; ``torch.bfloat16`` runs the Dense and GAT products in bf16
    (``_dense``, ``EdgeGATLayer``) while the parameters, BatchNorm, the
    softmax, the residual adds, the output and the loss stay float32."""

    def __init__(self, input_dim: int = 800, hidden_dim: int = 256,
                 output_dim: int = 800, n_layers: int = 3,
                 dropout: float = 0.1, residual: bool = True,
                 edge_dim: Optional[int] = 2,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.input_dim, self.output_dim = input_dim, output_dim
        self.n_layers = n_layers
        self.dropout = dropout
        self.residual = residual
        self.compute_dtype = compute_dtype
        self.input_proj = nn.Linear(input_dim, hidden_dim)
        self.input_bn = FlaxBatchNorm1d(hidden_dim, eps=1e-5, momentum=0.1)
        self.gat_layers = nn.ModuleList(
            EdgeGATLayer(hidden_dim, hidden_dim, edge_dim,
                         attn_dropout=dropout, compute_dtype=compute_dtype)
            for _ in range(n_layers))
        self.gat_bns = nn.ModuleList(
            FlaxBatchNorm1d(hidden_dim, eps=1e-5, momentum=0.1)
            for _ in range(n_layers))
        self.output_proj = nn.Linear(hidden_dim, output_dim)
        self.residual_proj = (nn.Linear(input_dim, output_dim)
                              if residual and input_dim != output_dim
                              else None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initialisers from ``generator``: LeCun-normal Dense
        kernels with zero bias, Glorot GAT weights, identity BatchNorm."""
        dense = [self.input_proj, self.output_proj]
        if self.residual_proj is not None:
            dense.append(self.residual_proj)
        for lin in dense:
            _lecun_normal_(lin.weight, lin.weight.shape[1], generator)
            with torch.no_grad():
                lin.bias.zero_()
        for gat in self.gat_layers:
            gat.reset_parameters(generator)
        for bn in [self.input_bn, *self.gat_bns]:
            bn.reset_parameters()

    def forward(self, features: torch.Tensor, neighbors: torch.Tensor,
                mask: torch.Tensor, edge_feats: Optional[torch.Tensor] = None,
                return_attention: bool = False,
                generator: Optional[torch.Generator] = None,
                draws: Optional[KeepDraws] = None):
        """``generator`` draws the dropout masks in train mode; ``draws``
        records them, or hands back recorded ones (``KeepDraws``)."""
        out, attentions = self.forward_slabs(
            [features], [neighbors], [mask], [edge_feats], generator, draws)
        if return_attention:
            return out[0], [a[0] for a in attentions]
        return out[0]

    def forward_slabs(self, features: List[torch.Tensor],
                      neighbors: List[torch.Tensor],
                      masks: List[torch.Tensor],
                      edge_feats: List[Optional[torch.Tensor]],
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[KeepDraws] = None):
        """The forward over contiguous node slabs, each on its own device
        (one slab: the whole graph), its rows' ``neighbors`` holding
        global node indices; returns (embeddings, attentions) per slab.
        Each layer's (n, C) transform is all-gathered onto every slab's
        device for the neighbour gather; BatchNorm takes the statistics
        of all slabs; dropout draws what one graph would draw (through
        ``draws`` when given); the
        parameters are replicated by differentiable copies, so a backward
        sums every slab's gradient into them."""
        dt = self.compute_dtype
        sizes = [f.shape[0] for f in features]
        devices = [f.device for f in features]
        x = self.input_bn.forward_slabs(
            [_dense(self.input_proj, f, dt) for f in features])
        x = [F.relu(v) for v in x]
        attentions = []
        for i, (gat, bn) in enumerate(zip(self.gat_layers, self.gat_bns)):
            x_prev = x
            h = [gat.transform(v) for v in x]
            h_all = _all_gathered(h)
            keep = _keep_masks(sizes, devices, neighbors[0].shape[1] + 1,
                               gat.attn_dropout, self.training, generator,
                               draws)
            outs = [gat.attend(h[s], h_all[s], neighbors[s], masks[s],
                               edge_feats[s], keep and keep[s])
                    for s in range(len(h))]
            attentions.append([a for _, a in outs])
            x = bn.forward_slabs([o for o, _ in outs])
            if i < self.n_layers - 1:
                keep = _keep_masks(sizes, devices, x[0].shape[1],
                                   self.dropout, self.training, generator,
                                   draws)
                x = [_dropped(F.relu(v), keep and keep[s], self.dropout)
                     for s, v in enumerate(x)]
            if self.residual and 0 < i < self.n_layers - 1:
                x = [v + p for v, p in zip(x, x_prev)]
        out = [_dense(self.output_proj, v, dt).float() for v in x]
        if self.residual:
            out = [o + (f if self.residual_proj is None
                        else _dense(self.residual_proj, f, dt).float())
                   for o, f in zip(out, features)]
        return out, attentions


def _all_gathered(h: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per slab, the concatenation of every slab's rows on that slab's
    device (one slab: itself)."""
    if len(h) == 1:
        return h
    full = torch.cat([v.to(h[0].device) for v in h])
    on = {}
    for v in h:
        on.setdefault(v.device, full.to(v.device))
    return [on[v.device] for v in h]


def gauge_parameters(model: SpectralGNN) -> tuple:
    """Names of the biases a triplet loss on the train-mode embeddings
    cannot see, so their true gradient is 0: each bias just before a
    train-mode BatchNorm (the batch mean removes it) and each that only
    shifts every embedding by one constant (the loss takes differences).
    Adam moves them by ±lr along rounding noise, so two implementations
    or devices part there; parity checks hold them through what they
    feed instead."""
    return ("input_proj.bias",
            *(f"gat_layers.{i}.bias" for i in range(model.n_layers)),
            f"gat_bns.{model.n_layers - 1}.bias", "output_proj.bias")


def create_spectral_gnn(input_dim: int = 800, hidden_dim: int = 256,
                        output_dim: int = 800, n_layers: int = 3,
                        dropout: float = 0.1, residual: bool = True,
                        edge_dim: Optional[int] = 2,
                        mixed_precision: bool = False,
                        generator: Optional[torch.Generator] = None
                        ) -> SpectralGNN:
    """Factory (JAX ``create_spectral_gnn``, gnn.py:171).
    ``mixed_precision`` computes in bf16 (``SpectralGNN.compute_dtype``)."""
    return SpectralGNN(input_dim=input_dim, hidden_dim=hidden_dim,
                       output_dim=output_dim, n_layers=n_layers,
                       dropout=dropout, residual=residual, edge_dim=edge_dim,
                       generator=generator,
                       compute_dtype=torch.bfloat16 if mixed_precision
                       else None)


def gnn_forward(model: SpectralGNN, graph: KeyframeGraph, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Forward over a graph of tensors (``graph_to_tensors``) → (n,
    output_dim) embeddings (JAX ``gnn_forward``, gnn.py:297). Eval mode
    (``train=False``, the model in eval mode) runs without autograd. Train
    mode (the model in train mode) keeps the autograd graph, draws dropout
    from ``generator`` and updates the BatchNorm buffers in place, where
    JAX returns new ``batch_stats``. Op by op: an eval forward on a card
    here is the declared eager path, counted in
    ``STATS["eager_forwards"]``. Its callers on a card are the
    evaluation's one forward a sequence (``evaluation.py``: a capture
    used once would cost more than it saves) and the dry run's
    one-device reference (``parallel/dryrun.py``); the train-mode forward
    runs inside the train step's own graph. Every online forward, the
    full graph of ``use_local_updates: false`` included, runs its
    bucket's ``EvalExecutable`` (``LocalUpdateGNN.forward_full``)."""
    if model.training != train:
        raise ValueError(f"gnn_forward(train={train}) needs the model in "
                         f"{'train' if train else 'eval'} mode; call "
                         f"model.{'train' if train else 'eval'}() first")
    args = (graph.features, graph.neighbors, graph.mask, graph.edge_feats)
    if train:
        return model(*args, generator=generator)
    if graph.features.device.type == "cuda":
        STATS["eager_forwards"] += 1
    with torch.no_grad():
        return model(*args)


POOL = SharedPool()     # every eval graph of a device: one memory pool
# builds: executables ``eval_executable`` made; sharded_op_by_op: calls of
# ``parallel.train.make_sharded_eval_step``'s op-by-op forward (the
# trainer's over distinct cards, and any direct caller)
STATS = {"captures": 0, "replays": 0, "eager_steps": 0, "eager_forwards": 0,
         "sharded_op_by_op": 0, "builds": 0}
_CACHE = ExecutableCache(STATS)


class EvalExecutable(GraphStep):
    """JAX's ``_jitted_eval_apply`` (gnn.py:202-208) for one (model,
    padded node count, degree, edge_dim): the graph's four arrays in, the
    (n, output_dim) embeddings out (``utils/graph_exec.GraphStep``). The
    step reads the model's parameters and BatchNorm buffers by address,
    so weights loaded into the same module in place (``load_state_dict``)
    are what the next replay reads; a module whose tensors were replaced
    or moved needs ``clear_cache()``."""

    def __init__(self, model: SpectralGNN, n_nodes: int, degree: int,
                 edge_dim: int, device: torch.device, use_graph: bool = True):
        super().__init__(device, use_graph, POOL, STATS)
        self._model = weakref.ref(model)
        f32 = torch.float32
        self.inputs = Arena([
            ("features", (n_nodes, model.input_dim), f32),
            ("neighbors", (n_nodes, degree), torch.int64),
            ("mask", (n_nodes, degree), torch.bool),
            ("edge_feats", (n_nodes, degree, edge_dim), f32)], device)
        self.outputs = Arena([("emb", (n_nodes, model.output_dim), f32)],
                             device)

    def _step(self) -> None:
        i = self.inputs.dev
        with torch.no_grad():
            self.outputs.dev["emb"].copy_(self._model()(
                i["features"], i["neighbors"], i["mask"], i["edge_feats"]))


def eval_executable(model: SpectralGNN, n_nodes: int, degree: int,
                    edge_dim: int, device: torch.device,
                    use_graph: bool = True) -> EvalExecutable:
    """The cached eval step of (device, n_nodes, degree, edge_dim, model);
    made on a miss, which drops the entries of models that no longer
    exist."""
    if model.training:
        raise ValueError("the eval step needs the model in eval mode; call "
                         "model.eval() first")
    graphed = use_graph and device.type == "cuda"
    return _CACHE.get(
        (str(device), int(n_nodes), int(degree), int(edge_dim), id(model),
         graphed),
        lambda: EvalExecutable(model, n_nodes, degree, edge_dim, device,
                               use_graph), (model,))


def cached_executables() -> list:
    """The eval executables in the cache, oldest first."""
    return _CACHE.values()


def clear_cache() -> None:
    """Drop every cached eval executable (and with them their graphs)."""
    _CACHE.clear()


class LocalUpdateGNN:
    """k-hop local refresh (JAX ``models.gnn.LocalUpdateGNN``,
    gnn.py:311-461): the GNN runs on the k-hop subgraph around the node
    that changed, padded to a power of two of at least 8 nodes (the
    bucket), and only the nodes whose whole receptive field lies inside
    that subgraph get their embeddings written back. The model is in eval
    mode (BatchNorm uses its running statistics), so a refreshed embedding
    equals the full-graph forward's.

    ``serve_step`` and ``encode_update_local`` run the serving executables
    of ``models/serving.py`` (one static step per bucket: on a card a
    replayed CUDA graph): the subgraph is written
    straight into the bucket's static input buffer with the scan and the
    scalars, one copy takes them to the device, and one fetch brings back
    the descriptor, the bucket's embeddings and, on a query, the top-k.
    The split path's ``forward_local`` and ``update_embeddings_local`` run
    the bucket's ``EvalExecutable`` (``forward_full``) the same way."""

    def __init__(self, model: SpectralGNN, k_hops: int = 3):
        if model.training:
            raise ValueError("LocalUpdateGNN runs the eval forward; call "
                             "model.eval() first")
        self.model = model
        self.k_hops = k_hops
        self.device = next(model.parameters()).device

    def forward_full(self, graph: KeyframeGraph) -> torch.Tensor:
        """(n, output_dim) eval embeddings of a numpy graph of any size n,
        on the host: the graph padded to its bucket (``bucket``,
        ``pad_graph``: isolated nodes, which change no real node's
        embedding) runs the bucket's ``EvalExecutable`` (its arrays staged
        into the pinned arena, one upload, the step, one download) and
        the first n rows come back. On a card the step is a graph replay;
        a failed capture or replay raises."""
        n = graph.n_nodes
        padded = pad_graph(graph, self.bucket(n))
        exe = eval_executable(self.model, padded.n_nodes, padded.max_degree,
                              padded.edge_feats.shape[2], self.device)
        out, _ = exe.run({"features": padded.features,
                          "neighbors": padded.neighbors, "mask": padded.mask,
                          "edge_feats": padded.edge_feats})
        return torch.from_numpy(out["emb"][:n])

    @staticmethod
    def bucket(n_nodes: int) -> int:
        """The padded node count of a subgraph of ``n_nodes``: the next
        power of two, at least 8 (the bucket sizes of the JAX package's
        compiled forwards)."""
        n = max(n_nodes, 8)
        return 1 << (n - 1).bit_length()

    @classmethod
    def _padded(cls, sub: KeyframeGraph) -> KeyframeGraph:
        return pad_graph(sub, cls.bucket(sub.n_nodes))

    def forward_local(self, manager, center_node: int,
                      k_hops: Optional[int] = None) -> torch.Tensor:
        """(1, output_dim) embedding of ``center_node`` from its k-hop
        subgraph only."""
        k = self.k_hops if k_hops is None else k_hops
        sub, mapping = manager.get_local_subgraph(center_node, k)
        return self.forward_full(self._padded(sub))[mapping[center_node]][None]

    def _core(self, manager, center_node: int, k: int) -> list:
        """The (k − n_layers)-hop core: a node h hops from the center has
        its whole n_layers-deep receptive field inside the k-hop subgraph
        only when h + n_layers ≤ k (at k = n_layers, the center alone)."""
        return sorted(manager.get_k_hop_neighbors(
            center_node, max(k - self.model.n_layers, 0)))

    def update_embeddings_local(self, manager, center_node: int,
                                k_hops: Optional[int] = None) -> list:
        """Refresh the core's embeddings in the graph manager; returns the
        refreshed window indices."""
        k = self.k_hops if k_hops is None else k_hops
        sub, mapping = manager.get_local_subgraph(center_node, k)
        core = self._core(manager, center_node, k)
        emb = self.forward_full(self._padded(sub))
        rows = emb[[mapping[n] for n in core]].numpy()
        for node, e in zip(core, rows):
            manager.keyframes[node].embedding = e
        return core

    def _local(self, manager, center_node: int,
               n_slots: Optional[int] = None):
        """(unpadded numpy subgraph, mapping, core, bucket); ``n_slots``
        overrides the bucket (a warm-up's bucket beyond)."""
        sub, mapping = manager.get_local_subgraph(center_node, self.k_hops)
        core = self._core(manager, center_node, self.k_hops)
        return sub, mapping, core, n_slots or self.bucket(sub.n_nodes)

    def _executable(self, points, sub: KeyframeGraph, n_slots: int, alpha,
                    enc_config, retriever=None, top_k: int = 0,
                    do_query: bool = False, n_points: Optional[int] = None):
        from neural_spectral_codec_torch.models.serving import (
            executable, step_shape)
        shape = step_shape((n_points, 4) if n_points else np.shape(points),
                           n_slots, sub.max_degree,
                           sub.edge_feats.shape[2], enc_config, alpha,
                           top_k=top_k, do_query=do_query,
                           do_insert=retriever is not None)
        device = self.device if retriever is None else retriever.device
        if device != self.device:
            raise ValueError(f"the model is on {self.device}, the database "
                             f"on {device}")
        return executable(self.model, retriever, shape, device)

    @staticmethod
    def _write_back(manager, center_node: int, core: list, desc: np.ndarray,
                    emb: np.ndarray) -> None:
        manager.set_node_features(center_node, desc)
        for node, e in zip(core, emb):
            manager.keyframes[node].embedding = e

    def serve_step(self, manager, center_node: int, points_padded, alpha,
                   enc_config, retrieval, do_query: bool,
                   query_pose_position=None, n_points: Optional[int] = None):
        """One online keyframe step (JAX gnn.py:372-435), one executable
        run and one fetch: encode the scan, write the descriptor into the
        center's feature row of the bucket, run the eval forward, query
        the stage-1 database BEFORE the insert against ``size −
        (context_window − 1)`` rows (the split path's insert-then-query
        with ``exclude_last=context_window`` sees the same rows), insert
        the row. ``retrieval`` is a ``TwoStageRetrieval``.

        With ``n_points`` the scan may come unpadded: the executable pads
        it to (n_points, 4) in its staging buffer, as ``pad_points`` would.

        Returns (descriptor, refreshed window indices, stage1), stage1
        being None without a query, else (indices, distances) of the
        finite entries, as ``retriever.query`` returns them."""
        sub, mapping, core, n_slots = self._local(manager, center_node)
        ret = retrieval.retriever
        exe = self._executable(points_padded, sub, n_slots, alpha, enc_config,
                               ret, int(min(retrieval.top_k, ret.capacity)),
                               do_query, n_points)
        qp = np.zeros(4, np.float32)
        if do_query and query_pose_position is not None:
            qp[:3] = np.asarray(query_pose_position)
            qp[3] = retrieval.spatial_filter_distance
        insert_pos = (np.asarray(query_pose_position, np.float32)
                      if query_pose_position is not None
                      else np.zeros(3, np.float32))
        rows = [mapping[n] for n in core]

        def dispatch(insert_at: int, eff: int):
            exe.stage(points_padded, sub, mapping[center_node], insert_at,
                      eff, qp, insert_pos)
            out = exe.execute()
            # the core's rows of the bucket's embeddings, selected here
            # as JAX selects them from its fetched array
            return (out["desc"].copy(), out["emb"][rows],
                    out["idx"].copy() if do_query else None,
                    out["dist"].copy() if do_query else None)

        desc, emb, idx, dist = ret.fused_dispatch(
            dispatch, insert=True,
            exclude_last=retrieval.context_window - 1 if do_query else 0)
        stage1 = None
        if do_query:
            keep = np.isfinite(dist)
            stage1 = (idx[keep].astype(np.int64), dist[keep])
        self._write_back(manager, center_node, core, desc, emb)
        return desc, core, stage1

    def warm_serve(self, manager, center_node: int, points_padded, alpha,
                   enc_config, retrieval,
                   n_slots: Optional[int] = None) -> int:
        """Build ``serve_step``'s executables (query off and on) at the
        bucket of ``center_node``'s subgraph, or at ``n_slots``, by scratch
        executions that leave the database as it was
        (``serving.scratch_execute``; refused at a full database). On a
        card the first execution captures the graph. Returns the
        bucket."""
        from neural_spectral_codec_torch.models.serving import (
            scratch_execute)
        sub, mapping, _, n_slots = self._local(manager, center_node, n_slots)
        ret = retrieval.retriever
        for do_query in (False, True):
            exe = self._executable(points_padded, sub, n_slots, alpha,
                                   enc_config, ret,
                                   int(min(retrieval.top_k, ret.capacity)),
                                   do_query)
            scratch_execute(exe, ret, lambda insert_at, eff, exe=exe:
                            exe.stage(points_padded, sub,
                                      mapping[center_node], insert_at, eff))
        return n_slots

    def encode_update_local(self, manager, center_node: int, points_padded,
                            alpha, enc_config,
                            n_slots: Optional[int] = None,
                            n_points: Optional[int] = None):
        """The node's descriptor and its k-hop local refresh in one
        executable run and one fetch (JAX gnn.py:437-461). The node was
        added with a placeholder descriptor; the computed one replaces it.
        ``n_slots`` overrides the bucket (a warm-up's bucket beyond);
        ``n_points`` as in ``serve_step``. Returns (descriptor, refreshed
        window indices)."""
        sub, mapping, core, n_slots = self._local(manager, center_node,
                                                  n_slots)
        exe = self._executable(points_padded, sub, n_slots, alpha, enc_config,
                               n_points=n_points)
        exe.stage(points_padded, sub, mapping[center_node])
        out = exe.execute()
        desc = out["desc"].copy()
        self._write_back(manager, center_node, core, desc,
                         out["emb"][[mapping[n] for n in core]])
        return desc, core
