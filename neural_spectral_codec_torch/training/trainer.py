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
(L2-in-gradient, not AdamW). The step-decayed learning rate lives in the
optimizer's ``param_groups``. Checkpoints are ``torch.save`` files
``<checkpoint_dir>/<name>.pt`` holding the model and optimizer state and
the training counters.
"""

from __future__ import annotations

import functools
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
from neural_spectral_codec_torch.models.gnn import SpectralGNN, gnn_forward
from neural_spectral_codec_torch.training.loss import triplet_loss
from neural_spectral_codec_torch.training.miner import (
    TripletMiner, create_triplet_miner)
from neural_spectral_codec_torch.training.validation import (
    recall_loop_closure)

logger = logging.getLogger(__name__)


def make_optimizer(model: torch.nn.Module, learning_rate: float = 5e-4,
                   weight_decay: float = 1e-5) -> torch.optim.Adam:
    """Adam with L2-in-gradient weight decay (JAX ``make_optimizer``,
    trainer.py:47, without its clip: ``train_step`` clips)."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            weight_decay=weight_decay)


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
    0-d tensor on the graph's device)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    emb = gnn_forward(model, graph, train=True, generator=generator)
    # index_select: its backward is an index_add (see EdgeGATLayer)
    rows = [emb.index_select(0, i) for i in (anchor_idx, pos_idx, neg_idx)]
    loss = triplet_loss(*rows, margin=margin, mask=triplet_mask,
                        normalize=normalize)
    loss.backward()
    if grad_clip:
        clip_by_global_norm_(list(model.parameters()), grad_clip)
    optimizer.step()
    return loss.detach()


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
    to a multiple of the mesh size, and validation shards its queries."""

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
                 shard_nodes: bool = False):
        self.device = resolve_device(device)
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
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.mesh = mesh
        self.shard_nodes = shard_nodes
        self._divisor = 1
        if mesh is not None:
            from neural_spectral_codec_torch.parallel.train import (
                make_sharded_eval_step, make_sharded_train_step)
            self._sharded_step = make_sharded_train_step(
                self.model, self.optimizer, mesh, shard_nodes=shard_nodes,
                normalize=normalize_embeddings, grad_clip=grad_clip)
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
        self.current_lr = lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr

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
        if self.mesh is None:
            dev_graph = graph_to_tensors(graph, self.device)
            step_fn = functools.partial(
                train_step, self.model, self.optimizer,
                grad_clip=self.grad_clip,
                normalize=self.normalize_embeddings)
        else:
            from neural_spectral_codec_torch.parallel.train import (
                place_graph)
            dev_graph = place_graph(graph, self.mesh, self.shard_nodes)
            step_fn = self._sharded_step
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

        losses = []
        for s in range(n_steps):
            batch = trip_d[s * B:(s + 1) * B]
            loss = step_fn(dev_graph, batch[:, 0], batch[:, 1], batch[:, 2],
                           mask_d[s * B:(s + 1) * B], self.margin,
                           generator=self._gen)
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
        ``normalize_embeddings``), as numpy."""
        self.model.eval()
        if self.mesh is None:
            emb = gnn_forward(self.model,
                              graph_to_tensors(graph, self.device))
        else:
            # isolated padding nodes (self-loop-only attention) leave the
            # real nodes' eval outputs as they are
            from neural_spectral_codec_torch.keyframe.graph import pad_graph
            from neural_spectral_codec_torch.parallel.train import (
                place_graph)
            n = graph.n_nodes
            padded = pad_graph(graph, -(-n // self._divisor) * self._divisor)
            emb = self._sharded_eval(place_graph(
                padded, self.mesh, self.shard_nodes))[:n]
        emb = emb.cpu().numpy()
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
        for k in sorted(ks):
            r, nq = recall_loop_closure(emb, val_poses, k,
                                        distance_threshold, skip_frames,
                                        device=self.device, mesh=self.mesh)
            metrics[f"recall@{k}"] = r
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
        ``GNNTrainer.train``, trainer.py:290)."""
        if triplet_miner is None:
            triplet_miner = create_triplet_miner(device=self.device)
        logger.info("Training for %d epochs on %d-node graph",
                    n_epochs, train_graph.n_nodes)
        t_start = time.perf_counter()
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
            self._log_metrics({"train_loss": avg_loss, "lr": self.current_lr,
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
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.current_lr = self.optimizer.param_groups[0]["lr"]
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
