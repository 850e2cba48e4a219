"""GNN trainer: full-graph train steps with the triplet loss. Port of
``neural_spectral_codec_tpu/training/trainer.py``.

Each optimizer step runs one full-graph train-mode forward, gathers the
anchor, positive and negative rows of 4096 triplets (padded, with a
mask), takes the masked triplet loss and steps Adam: the reference's
4 × 1024-triplet gradient accumulation as one step, as in the JAX
package. BatchNorm statistics update once per step.

The optimizer mirrors the JAX package's ``optax`` chain
``clip_by_global_norm → add_decayed_weights → adam``: the clip is written
by hand (``g / ‖g‖ · max_norm`` when ‖g‖ ≥ max_norm; ``clip_grad_norm_``
would add 1e-6 to the norm), then ``torch.optim.Adam(weight_decay=)``,
which adds ``weight_decay · p`` to the gradient before the moments
(L2-in-gradient, not AdamW). The step-decayed learning rate is a 0-d
float32 tensor on the parameters' device, shared by the param groups and
written in place; on a card Adam is ``capturable`` (its step count on the
device, no host synchronisation). Checkpoints are ``torch.save`` files
``<checkpoint_dir>/<name>.pt`` holding the model and optimizer state and
the training counters.

JAX's ``train_step`` is one compiled program; here it is a
``TrainStepExecutable``: on a card with ``use_graph`` one captured CUDA
graph (the train forward with BatchNorm's running statistics updated in
place and dropout drawn from the trainer's generator, registered with the
graph; the gathers, whose backward is kernel G; the loss, backward, clip
and Adam), replayed each step; the graph's arrays sit in a device arena
for the run and each step copies its triplets and mask into static
buffers. ``embed`` runs the eval forward as one ``gnn.EvalExecutable``
graph of the graph's own size, validation its two scans as graphs too.
On a one-device mesh the sharded step and forward are such graphs too
(``parallel.train``); over distinct cards they run op by op.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.keyframe.graph import (
    KeyframeGraph, graph_to_tensors)
from neural_spectral_codec_torch.models import gather_kernel
from neural_spectral_codec_torch.models.gather_kernel import gather_rows
from neural_spectral_codec_torch.models.gnn import (
    EvalExecutable, SpectralGNN, gnn_forward)
from neural_spectral_codec_torch.training import miner as miner_mod
from neural_spectral_codec_torch.training import validation as validation_mod
from neural_spectral_codec_torch.training.loss import triplet_loss
from neural_spectral_codec_torch.training.miner import (
    TripletMiner, create_triplet_miner)
from neural_spectral_codec_torch.training.validation import recall_at_ks
from neural_spectral_codec_torch.utils.graph_exec import (
    Arena, GraphStep, SharedPool)

logger = logging.getLogger(__name__)

POOL = SharedPool()     # every train-step graph of a device: one memory pool
# sharded_op_by_op: calls of ``parallel.train.make_sharded_train_step``'s
# op-by-op step (the trainer's over distinct cards, and any direct caller)
STATS = {"captures": 0, "replays": 0, "eager_steps": 0,
         "sharded_op_by_op": 0}


def make_optimizer(model: torch.nn.Module, learning_rate: float = 5e-4,
                   weight_decay: float = 1e-5) -> torch.optim.Adam:
    """Adam with L2-in-gradient weight decay (JAX ``make_optimizer``,
    trainer.py:47, without its clip: ``train_step`` clips). The learning
    rate is a 0-d float32 tensor on the parameters' device (write it with
    ``fill_``). On a card Adam is ``capturable``: the step count on the
    device and the update free of host synchronisation, so that a CUDA
    graph can hold it (PyTorch takes that on a card only)."""
    dev = next(model.parameters()).device
    capturable = dev.type == "cuda"
    lr = torch.tensor(float(learning_rate), dtype=torch.float32, device=dev)
    return torch.optim.Adam(model.parameters(), lr=lr,
                            weight_decay=weight_decay, capturable=capturable,
                            foreach=capturable)


def clip_by_global_norm_(params: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place: each gradient becomes ``g / ‖g‖ · max_norm`` when the global
    norm ‖g‖ ≥ ``max_norm``. Returns the norm before clipping. No host
    synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def train_step(model: SpectralGNN, optimizer: torch.optim.Optimizer,
               graph: KeyframeGraph, anchor_idx: torch.Tensor,
               pos_idx: torch.Tensor, neg_idx: torch.Tensor,
               triplet_mask: torch.Tensor, margin: float,
               grad_clip: Optional[float] = 1.0,
               generator: Optional[torch.Generator] = None,
               normalize: bool = False) -> torch.Tensor:
    """One optimizer step (JAX ``train_step``, trainer.py:73): train-mode
    forward over the graph of tensors, masked triplet loss over the
    gathered rows, backward, global-norm clip, Adam. Updates the model's
    parameters and BatchNorm buffers in place and returns the loss (a
    0-d tensor on the graph's device). Static shapes and no host
    synchronisation: ``TrainStepExecutable`` captures it."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    emb = gnn_forward(model, graph, train=True, generator=generator)
    # the gathers' backward is kernel G; padded triplets (mask off) carry a
    # zero gradient and are left out of its segments
    rows = [gather_rows(emb, i, valid=triplet_mask)
            for i in (anchor_idx, pos_idx, neg_idx)]
    loss = triplet_loss(*rows, margin=margin, mask=triplet_mask,
                        normalize=normalize)
    loss.backward()
    if grad_clip:
        clip_by_global_norm_(list(model.parameters()), grad_clip)
    optimizer.step()
    return loss.detach()


class TrainStepExecutable(GraphStep):
    """JAX's ``train_step`` (trainer.py:73) for one (model, optimizer, n
    nodes, degree, edge width, B triplets, margin, clip, normalize): the
    graph in the device arena ``graph_data`` (``load_graph``, once a run),
    each step's (B, 3) triplets and (B,) mask staged into ``inputs``, the
    loss out (``utils/graph_exec.GraphStep``). The step updates the
    model's parameters and buffers and the optimizer's state in place, so
    the capturing run is the warm-up's step and does not replay; dropout
    draws from ``generator``, which the graph registers. The step reads
    the parameters, buffers and optimizer state by address: a module or
    optimizer whose tensors were replaced needs a new executable."""

    warmup_is_the_run = True

    def __init__(self, model: SpectralGNN, optimizer: torch.optim.Optimizer,
                 n_nodes: int, degree: int, edge_dim: int, batch: int,
                 margin: float, grad_clip: Optional[float], normalize: bool,
                 generator: Optional[torch.Generator],
                 device: torch.device, use_graph: bool = True):
        super().__init__(device, use_graph, POOL, STATS)
        self.model, self.optimizer = model, optimizer
        self.margin, self.grad_clip = margin, grad_clip
        self.normalize, self.generator = normalize, generator
        self.shape = (n_nodes, degree, edge_dim, batch)
        self.graph_arrays: tuple = ()
        f32 = torch.float32
        self.graph_data = Arena([
            ("features", (n_nodes, model.input_dim), f32),
            ("neighbors", (n_nodes, degree), torch.int64),
            ("mask", (n_nodes, degree), torch.bool),
            ("edge_feats", (n_nodes, degree, edge_dim), f32)], device,
            host=False)
        self.inputs = Arena([("triplets", (batch, 3), torch.int64),
                             ("tmask", (batch,), torch.bool)], device)
        self.outputs = Arena([("loss", (), f32)], device)

    def load_graph(self, graph: KeyframeGraph) -> None:
        """The graph's arrays into the device arena; the executable then
        holds this graph (``holds``)."""
        self.load(self.graph_data, graph_to_tensors(graph, self.device)
                  ._asdict())
        self.graph_arrays = tuple(graph)

    def holds(self, graph: KeyframeGraph) -> bool:
        """Whether the arena holds these very arrays."""
        return len(self.graph_arrays) == len(graph) and all(
            a is b for a, b in zip(self.graph_arrays, graph))

    def _kernels(self) -> tuple:
        return (gather_kernel.KERNEL,)

    def _generators(self) -> tuple:
        gen = self.generator
        return (gen,) if gen is not None and gen.device.type == "cuda" else ()

    def gathers(self) -> int:
        """G's launches a step: the 3 triplet gathers and one a GAT
        layer."""
        return 3 + self.model.n_layers

    def _check(self, graph) -> None:
        from neural_spectral_codec_torch._build import graph_census
        self.census = graph_census(graph.raw_cuda_graph())
        want = self.gathers()
        if self.census["gather_bwd"] != want:
            raise RuntimeError(f"the train graph holds "
                               f"{self.census['gather_bwd']} gather backward "
                               f"kernels, not {want}")

    def _step(self) -> None:
        g, i = self.graph_data.dev, self.inputs.dev
        t = i["triplets"]
        loss = train_step(self.model, self.optimizer, KeyframeGraph(
            g["features"], g["neighbors"], g["mask"], g["edge_feats"]),
            t[:, 0], t[:, 1], t[:, 2], i["tmask"], self.margin,
            grad_clip=self.grad_clip, generator=self.generator,
            normalize=self.normalize)
        self.outputs.dev["loss"].copy_(loss)


class GNNTrainer:
    """Offline trainer (JAX ``GNNTrainer``, trainer.py:97). The model's
    parameters are initialised from ``seed`` (as ``init_gnn`` does in the
    JAX package) and live on ``device``; dropout draws from a generator on
    the device seeded from ``seed``.

    ``mesh`` (``parallel.Mesh``, whose first device must be ``device``)
    trains over its devices (``parallel.make_sharded_train_step``): the
    triplet batch, padded to a multiple of the mesh size, is split over
    the devices, and with ``shard_nodes`` the graph's nodes too. The
    embedding pass then runs the sharded eval forward on the graph padded
    to a multiple of the mesh size, and validation shards its queries.
    On a one-device mesh (``Mesh.one_device``) the step and the forward
    are ``parallel.train``'s executables, as on one device; over
    distinct cards they run op by op (counted ``sharded_op_by_op``)."""

    def __init__(self, model: Optional[SpectralGNN] = None,
                 learning_rate: float = 5e-4, weight_decay: float = 1e-5,
                 margin: float = 0.1, grad_clip: Optional[float] = 1.0,
                 checkpoint_dir: str = "checkpoints", log_interval: int = 10,
                 patience: int = 10, triplets_per_step: int = 4096,
                 seed: int = 0,
                 lr_decay_epochs: Optional[List[int]] = None,
                 lr_decay_factor: float = 0.1, min_lr: float = 1e-6,
                 normalize_embeddings: bool = False,
                 device: DeviceLike = "cuda", mesh=None,
                 shard_nodes: bool = False, use_graph: bool = True):
        self.device = resolve_device(device)
        self.use_graph = use_graph
        if mesh is not None and mesh.devices[0] != self.device:
            raise ValueError(f"the mesh starts at {mesh.devices[0]}, the "
                             f"trainer's device is {self.device}")
        # initialised on the host from ``seed``, then moved
        self.model = (model or SpectralGNN()).cpu()
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.margin = margin
        self.grad_clip = grad_clip
        self.normalize_embeddings = normalize_embeddings
        self.lr_decay_epochs = set(lr_decay_epochs or [])
        self.lr_decay_factor = lr_decay_factor
        self.min_lr = min_lr
        self.current_lr = learning_rate
        self.optimizer = make_optimizer(self.model, learning_rate,
                                        weight_decay)
        self._lr = self.optimizer.param_groups[0]["lr"]
        self._train_exe: Optional[TrainStepExecutable] = None
        self._embed_exes: Dict[tuple, EvalExecutable] = {}
        self._several = mesh is not None and not mesh.one_device
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.mesh = mesh
        self.shard_nodes = shard_nodes
        self._divisor = 1
        if mesh is not None:
            if self._several:
                from neural_spectral_codec_torch.parallel.train import (
                    make_sharded_eval_step, make_sharded_train_step)
                self._sharded_step = make_sharded_train_step(
                    self.model, self.optimizer, mesh,
                    shard_nodes=shard_nodes, normalize=normalize_embeddings,
                    grad_clip=grad_clip)
                self._sharded_eval = make_sharded_eval_step(
                    self.model, mesh, shard_nodes=shard_nodes)
            self._divisor = mesh.size
            logger.info("Training over %d devices (%s)", mesh.size,
                        "nodes sharded" if shard_nodes else "data-parallel")

        self.checkpoint_dir = Path(checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.log_interval = log_interval
        self.patience = patience
        self.triplets_per_step = triplets_per_step

        self.epoch = 0
        self.global_step = 0
        self.best_val_metric = 0.0
        self.epochs_without_improvement = 0
        self.train_losses: List[float] = []
        self.val_metrics: List[Dict] = []
        self.metrics_path = self.checkpoint_dir / "metrics.jsonl"

    def _log_metrics(self, record: Dict) -> None:
        record = {"epoch": self.epoch, "global_step": self.global_step,
                  "time": time.time(), **record}
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def set_learning_rate(self, lr: float) -> None:
        """Write ``lr`` into the optimizer's learning-rate tensor (which a
        captured train step reads)."""
        self.current_lr = lr
        self._lr.fill_(lr)
        for group in self.optimizer.param_groups:
            group["lr"] = self._lr

    def load_optimizer_state(self, state: dict) -> None:
        """Load an Adam ``state_dict`` (this trainer's, one saved on
        another kind of device, or ``convert.from_optax_adam``'s) and keep
        this optimizer's own form: its ``capturable`` and ``foreach``
        (the saved groups' replace them), the step counts on the
        parameters' device where capturable, the learning rate written
        into its tensor. The loaded state holds new tensors, so the train
        graph is made anew at the next step."""
        own = [(g["capturable"], g["foreach"])
               for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(state)
        for group, (capturable, foreach) in zip(
                self.optimizer.param_groups, own):
            group["capturable"], group["foreach"] = capturable, foreach
            for p in group["params"]:
                st = self.optimizer.state.get(p, {})
                if "step" in st:
                    st["step"] = st["step"].to(
                        device=p.device if capturable else "cpu",
                        dtype=torch.float32)
        self._train_exe = None
        self.set_learning_rate(float(self.optimizer.param_groups[0]["lr"]))

    def train_step_executable(self, graph: KeyframeGraph,
                              batch: int) -> TrainStepExecutable:
        """The run's train step for ``graph`` and ``batch`` triplets (on a
        one-device mesh ``parallel.train.ShardedTrainStepExecutable``):
        kept while the trainer trains on the same arrays, made anew (its
        graph loaded) otherwise."""
        exe = self._train_exe
        shape = (graph.n_nodes, graph.max_degree, graph.edge_feats.shape[2],
                 batch)
        if exe is None or exe.shape != shape or not exe.holds(graph):
            args = (*shape, self.margin, self.grad_clip,
                    self.normalize_embeddings, self._gen)
            if self.mesh is None:
                exe = TrainStepExecutable(self.model, self.optimizer, *args,
                                          self.device, self.use_graph)
            else:
                from neural_spectral_codec_torch.parallel.train import (
                    ShardedTrainStepExecutable)
                exe = ShardedTrainStepExecutable(
                    self.model, self.optimizer, self.mesh, self.shard_nodes,
                    *args, self.use_graph)
            exe.load_graph(graph)
            self._train_exe = exe
        return exe

    def release_graphs(self) -> None:
        """Free what the training graphs keep on the device: this
        trainer's train step and embedding passes, and every cached mining
        and validation executable (data arenas and graphs). Each is made
        again at its next use. ``train`` calls it when it ends."""
        self._train_exe = None
        self._embed_exes.clear()
        miner_mod.clear_cache()
        validation_mod.clear_cache()

    # ------------------------------------------------------------------

    def train_epoch(self, graph: KeyframeGraph, triplet_miner: TripletMiner,
                    poses: np.ndarray, descriptors: np.ndarray,
                    sequence_ids: Optional[np.ndarray] = None,
                    n_triplets_per_anchor: int = 1) -> float:
        """Mine, shuffle (seeded by the epoch), then padded steps of
        ``triplets_per_step`` triplets over the full graph; returns the
        mean step loss (0.0 when nothing was mined)."""
        t0 = time.perf_counter()
        triplets = triplet_miner.mine_triplets(
            descriptors=descriptors, poses=poses,
            n_triplets_per_anchor=n_triplets_per_anchor,
            sequence_ids=sequence_ids)
        if len(triplets) == 0:
            logger.warning("No valid triplets mined!")
            self.train_losses.append(0.0)
            return 0.0
        logger.info("Mined %d triplets in %.2fs", len(triplets),
                    time.perf_counter() - t0)

        perm = np.random.default_rng(self.epoch).permutation(len(triplets))
        triplets = triplets[perm]
        # padded so that every step (and every device's share) is full
        B = -(-self.triplets_per_step // self._divisor) * self._divisor
        n_steps = -(-len(triplets) // B)
        pad = n_steps * B - len(triplets)
        tmask = np.ones(len(triplets), bool)
        if pad:
            triplets = np.concatenate([triplets, np.zeros((pad, 3), np.int64)])
            tmask = np.concatenate([tmask, np.zeros(pad, bool)])
        trip_d = torch.from_numpy(triplets).to(self.device)
        mask_d = torch.from_numpy(tmask).to(self.device)
        if not self._several:
            exe = self.train_step_executable(graph, B)

            def step_fn(s):
                out, _ = exe.run({"triplets": trip_d[s * B:(s + 1) * B],
                                  "tmask": mask_d[s * B:(s + 1) * B]},
                                 fetch=False)
                return out["loss"]
        else:   # distinct cards: op by op
            from neural_spectral_codec_torch.parallel.train import (
                place_graph)
            dev_graph = place_graph(graph, self.mesh, self.shard_nodes)

            def step_fn(s):
                batch = trip_d[s * B:(s + 1) * B]
                return self._sharded_step(
                    dev_graph, batch[:, 0], batch[:, 1], batch[:, 2],
                    mask_d[s * B:(s + 1) * B], self.margin,
                    generator=self._gen)

        losses = []
        for s in range(n_steps):
            loss = step_fn(s)
            self.global_step += 1
            losses.append(loss)
            if self.global_step % self.log_interval == 0:
                logger.info("Epoch %d | Step %d/%d | Loss: %.4f",
                            self.epoch + 1, s + 1, n_steps, float(loss))
        avg = float(torch.stack(losses).mean())
        self.train_losses.append(avg)
        return avg

    # ------------------------------------------------------------------

    def embed(self, graph: KeyframeGraph) -> np.ndarray:
        """Eval-mode embeddings of every node (L2-normalised with
        ``normalize_embeddings``), as numpy. On one device: the
        ``gnn.EvalExecutable`` of the graph's own size (on a card with
        ``use_graph`` a captured graph, made once a run): its arrays
        staged, one upload, the forward, one download. On a mesh the
        graph is padded to a multiple of the mesh size (isolated padding
        nodes, self-loop-only attention, leave the real nodes' outputs as
        they are) and runs the sharded forward: on one device
        ``parallel.train.ShardedEvalExecutable``, staged and fetched the
        same way; over distinct cards op by op. The trainer keeps one
        executable a graph shape until ``release_graphs``."""
        from neural_spectral_codec_torch.keyframe.graph import pad_graph
        self.model.eval()
        n = graph.n_nodes
        padded = pad_graph(graph, -(-n // self._divisor) * self._divisor)
        if self._several:
            from neural_spectral_codec_torch.parallel.train import (
                place_graph)
            emb = self._sharded_eval(place_graph(
                padded, self.mesh, self.shard_nodes))[:n].cpu().numpy()
        else:
            shape = (padded.n_nodes, graph.max_degree,
                     graph.edge_feats.shape[2])
            exe = self._embed_exes.get(shape)
            if exe is None:
                if self.mesh is None:
                    exe = EvalExecutable(self.model, *shape, self.device,
                                         self.use_graph)
                else:
                    from neural_spectral_codec_torch.parallel.train import (
                        ShardedEvalExecutable)
                    exe = ShardedEvalExecutable(
                        self.model, self.mesh, self.shard_nodes, *shape,
                        self.use_graph)
                self._embed_exes[shape] = exe
            out, _ = exe.run({"features": padded.features,
                              "neighbors": padded.neighbors,
                              "mask": padded.mask,
                              "edge_feats": padded.edge_feats})
            emb = out["emb"][:n]
        if self.normalize_embeddings:
            emb = emb / np.maximum(
                np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        return emb

    def validate(self, val_graph: KeyframeGraph, val_poses: np.ndarray,
                 distance_threshold: float = 5.0, skip_frames: int = 30,
                 ks=(1, 5, 10)) -> Dict[str, float]:
        emb = self.embed(val_graph)
        metrics = {}
        ks = tuple(ks)
        if 1 not in ks:           # R@1 drives best-checkpoint/early-stop
            ks = (1,) + ks
        recall, nq = recall_at_ks(emb, val_poses, ks, distance_threshold,
                                  skip_frames, device=self.device,
                                  mesh=self.mesh, use_graph=self.use_graph)
        for k in sorted(recall):
            metrics[f"recall@{k}"] = recall[k]
        metrics["n_queries"] = nq
        logger.info("Validation | %s | Q=%d",
                    " | ".join(f"R@{k} {metrics[f'recall@{k}']:.4f}"
                               for k in sorted(ks)),
                    metrics["n_queries"])
        return metrics

    # ------------------------------------------------------------------

    def train(self, train_graph: KeyframeGraph, train_poses: np.ndarray,
              train_descriptors: np.ndarray,
              train_sequence_ids: Optional[np.ndarray] = None,
              val_graph: Optional[KeyframeGraph] = None,
              val_poses: Optional[np.ndarray] = None,
              n_epochs: int = 50,
              triplet_miner: Optional[TripletMiner] = None,
              early_stopping: bool = True,
              n_triplets_per_anchor: int = 1,
              recall_ks=(1, 5, 10),
              save_best: bool = True, save_last: bool = True,
              save_every_epochs: int = 10) -> None:
        """Epoch loop with step lr decay, validation, best/periodic/final
        checkpoints and patience-based early stopping (JAX
        ``GNNTrainer.train``, trainer.py:290). The training graphs are
        released when it returns (``release_graphs``)."""
        if triplet_miner is None:
            triplet_miner = create_triplet_miner(device=self.device,
                                                 use_graph=self.use_graph)
        logger.info("Training for %d epochs on %d-node graph",
                    n_epochs, train_graph.n_nodes)
        t_start = time.perf_counter()
        try:
            for epoch in range(n_epochs):
                self.epoch = epoch
                if epoch in self.lr_decay_epochs:
                    self.set_learning_rate(max(
                        self.current_lr * self.lr_decay_factor, self.min_lr))
                    logger.info("Epoch %d: learning rate -> %.2e", epoch + 1,
                                self.current_lr)
                t0 = time.perf_counter()
                avg_loss = self.train_epoch(
                    train_graph, triplet_miner, train_poses, train_descriptors,
                    sequence_ids=train_sequence_ids,
                    n_triplets_per_anchor=n_triplets_per_anchor)
                self._log_metrics({"train_loss": avg_loss,
                                   "lr": self.current_lr,
                                   "epoch_seconds": time.perf_counter() - t0})
                if val_graph is not None and val_poses is not None:
                    metrics = self.validate(val_graph, val_poses, ks=recall_ks)
                    self.val_metrics.append(metrics)
                    self._log_metrics(dict(metrics))
                    logger.info("Epoch %d/%d | Loss %.4f | R@1 %.4f | %.1fs",
                                epoch + 1, n_epochs, avg_loss,
                                metrics["recall@1"], time.perf_counter() - t0)
                    if metrics["recall@1"] > self.best_val_metric:
                        self.best_val_metric = metrics["recall@1"]
                        if save_best:
                            self.save_checkpoint("best_model")
                        self.epochs_without_improvement = 0
                    else:
                        self.epochs_without_improvement += 1
                    if early_stopping and \
                            self.epochs_without_improvement >= self.patience:
                        logger.info("Early stopping after %d stale epochs "
                                    "(best R@1 %.4f)", self.patience,
                                    self.best_val_metric)
                        break
                else:
                    logger.info("Epoch %d/%d | Loss %.4f | %.1fs",
                                epoch + 1, n_epochs, avg_loss,
                                time.perf_counter() - t0)
                if save_every_epochs and (epoch + 1) % save_every_epochs == 0:
                    self.save_checkpoint(f"checkpoint_epoch_{epoch + 1}")
            if save_last:
                self.save_checkpoint("final_model")
            logger.info("Training complete in %.1fs | best R@1 %.4f",
                        time.perf_counter() - t_start, self.best_val_metric)
        finally:
            self.release_graphs()

    # ------------------------------------------------------------------

    def checkpoint_path(self, name: str) -> Path:
        return self.checkpoint_dir / f"{name}.pt"

    def save_checkpoint(self, name: str) -> None:
        path = self.checkpoint_path(name)
        torch.save({
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "meta": {
                "epoch": self.epoch,
                "global_step": self.global_step,
                "best_val_metric": self.best_val_metric,
                "epochs_without_improvement": self.epochs_without_improvement,
                "train_losses": [float(v) for v in self.train_losses],
            },
        }, path)
        logger.info("Saved checkpoint: %s", path)

    def load_checkpoint(self, name: str) -> None:
        path = self.checkpoint_path(name)
        if not path.exists():
            raise FileNotFoundError(f"Checkpoint not found: {path}")
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        self.load_optimizer_state(ckpt["optimizer"])
        meta = ckpt["meta"]
        self.epoch = int(meta["epoch"])
        self.global_step = int(meta["global_step"])
        self.best_val_metric = float(meta["best_val_metric"])
        self.epochs_without_improvement = int(
            meta["epochs_without_improvement"])
        self.train_losses = list(meta["train_losses"])
        logger.info("Loaded checkpoint: %s (epoch %d, best R@1 %.4f)",
                    path, self.epoch, self.best_val_metric)


def create_trainer(model: Optional[SpectralGNN] = None,
                   **kwargs) -> GNNTrainer:
    """Factory (JAX ``create_trainer``, trainer.py:408)."""
    return GNNTrainer(model=model, **kwargs)
