"""Offline training pipeline: loader → keyframe selection → batched
descriptors on the device → keyframe graph → GNN training. Port of the
training half of ``neural_spectral_codec_tpu/pipeline.py`` (``BatchEncoder``
and ``RingMajorBatchEncoder``, :79-229; the config wiring of
``NeuralSpectralCodecPipeline.__init__`` that training reads, :235-310;
``_process_sequence``, :378; ``train_offline``, :428) on one device.

On a CUDA device the general encoder launches ``csrc/project.cu`` and
``csrc/spectral.cu``, the ring-major encoder ``csrc/ring_fold.cu`` and
``csrc/spectral.cu`` for the scans that meet the ring contract. The
pipeline takes a config dict (``utils.config.load_config`` reads one from
YAML). Not ported here: the online half (graph manager, two-stage
retrieval, ``run_online``), the native read-ahead (scans are read by
indexing the loader), bf16 ``training.mixed_precision`` (raises) and
mesh training.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from neural_spectral_codec_torch.data.pose_utils import (
    is_valid_transformation)
from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.keyframe.graph import (
    build_graph_from_keyframes)
from neural_spectral_codec_torch.keyframe.selector import (
    Keyframe, KeyframeSelector)
from neural_spectral_codec_torch.models.gnn import create_spectral_gnn
from neural_spectral_codec_torch.ops.range_image import pad_points
from neural_spectral_codec_torch.ops.spectral import (
    SpectralEncoderConfig, encode_points_batch)
from neural_spectral_codec_torch.training.miner import create_triplet_miner
from neural_spectral_codec_torch.training.trainer import GNNTrainer
from neural_spectral_codec_torch.utils.config import get as cfg_get

logger = logging.getLogger(__name__)


class BatchEncoder:
    """Descriptors of host clouds in device batches of ``batch_size``:
    each cloud NaN-padded (or cut) to ``max_points``, then
    ``encode_points_batch``. ``path_counts`` counts the scans each path
    encoded."""

    def __init__(self, config: SpectralEncoderConfig, alpha: float = 2.0,
                 max_points: int = 131072, batch_size: int = 64,
                 device: DeviceLike = "cuda"):
        self.config = config
        self.alpha = float(alpha)
        self.max_points = max_points
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.path_counts = {"ring": 0, "general": 0}

    def encode(self, clouds: Sequence[np.ndarray],
               ring_ids: Optional[Sequence] = None) -> np.ndarray:
        """(n, output_dim) float32 descriptors; ``ring_ids`` is read by the
        ring-major encoder only."""
        out = []
        for i in range(0, len(clouds), self.batch_size):
            batch = np.stack([pad_points(c, self.max_points)
                              for c in clouds[i:i + self.batch_size]])
            out.append(encode_points_batch(
                torch.from_numpy(batch).to(self.device), self.alpha,
                self.config).cpu().numpy())
        self.path_counts["general"] += len(clouds)
        return np.concatenate(out) if out else np.zeros(
            (0, self.config.output_dim), np.float32)

    def encode_one(self, cloud: np.ndarray,
                   ring_ids: Optional[np.ndarray] = None) -> np.ndarray:
        return self.encode([cloud])[0]


class RingMajorBatchEncoder(BatchEncoder):
    """``encoding.ring_major: true``: each scan whose rings can be
    recovered (explicit ids, else sweep order, else elevation bands) and
    that meets the ring contract (``ops.ring_path.prepare_structured``)
    takes the ring path, in batches of ``RING_B`` scans of one ring layout;
    every other scan takes the general path. Descriptors equal the base
    encoder's."""

    RING_B = 8

    def _prepare_auto(self, cloud: np.ndarray, explicit_ids):
        from neural_spectral_codec_torch.ops.ring_path import (
            infer_ring_ids_by_elevation, infer_ring_ids_from_sweep,
            prepare_structured)
        if explicit_ids is not None:
            return prepare_structured(
                cloud, np.asarray(explicit_ids)[:self.max_points],
                self.config)
        prep = prepare_structured(cloud, infer_ring_ids_from_sweep(cloud),
                                  self.config)
        if prep is None:
            rid = infer_ring_ids_by_elevation(cloud)
            if rid is not None:
                prep = prepare_structured(cloud, rid, self.config)
        return prep

    def _encode_rings(self, rings: np.ndarray, rows) -> np.ndarray:
        from neural_spectral_codec_torch.ops.ring_path import (
            encode_points_ring_batch)
        self.path_counts["ring"] += len(rings)
        return encode_points_ring_batch(
            torch.from_numpy(rings).to(self.device), self.alpha, self.config,
            rows).cpu().numpy()

    def encode(self, clouds: Sequence[np.ndarray],
               ring_ids: Optional[Sequence] = None) -> np.ndarray:
        out = np.zeros((len(clouds), self.config.output_dim), np.float32)
        pending: Dict = {}
        fallback: List[int] = []

        def flush(key, items):
            d = self._encode_rings(np.stack([r for _, r in items]), key[0])
            for j, (i, _) in enumerate(items):
                out[i] = d[j]

        # a group is flushed as soon as it fills, so at most one batch of
        # prepared ring-major copies per ring layout is held
        for i, cloud in enumerate(clouds):
            c = np.asarray(cloud)[:self.max_points]
            prep = (self._prepare_auto(
                c, ring_ids[i] if ring_ids is not None else None)
                if len(c) else None)
            if prep is None:
                fallback.append(i)
                continue
            rings, rows = prep
            key = (rows, rings.shape)
            pending.setdefault(key, []).append((i, rings))
            if len(pending[key]) == self.RING_B:
                flush(key, pending.pop(key))
        for key, items in pending.items():
            flush(key, items)
        if fallback:
            d = super().encode([np.asarray(clouds[i]) for i in fallback])
            out[fallback] = d
        return out


class NeuralSpectralCodecPipeline:
    """Config-driven wiring of the offline training path on ``device``.
    ``stage_seconds`` holds host-clock seconds per stage (selection and
    encoding per sequence, graph build, training)."""

    def __init__(self, config: Dict, device: DeviceLike = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.stage_seconds: Dict[str, float] = defaultdict(float)

        enc = config.get("encoding", {})
        self.encoder_config = SpectralEncoderConfig(
            n_elevation=enc.get("n_elevation", 16),
            n_azimuth=enc.get("n_azimuth", 360),
            n_bins=enc.get("n_bins", 50),
            target_elevation_bins=enc.get("target_elevation_bins", 16),
            alpha=enc.get("alpha", 2.0),
            epsilon=enc.get("epsilon", 1e-8),
            interpolate_empty=enc.get("interpolate_empty", True),
            elevation_range_deg=tuple(enc.get("elevation_range",
                                              (-24.8, 2.0))),
            max_range=enc.get("max_range", 80.0),
            min_range=enc.get("min_range", 1.0),
            elevation_mode=enc.get("elevation_mode", "clip"),
        )
        encoder_cls = (RingMajorBatchEncoder if enc.get("ring_major")
                       else BatchEncoder)
        self.encoder = encoder_cls(
            self.encoder_config, alpha=enc.get("alpha", 2.0),
            max_points=enc.get("max_points", 131072),
            batch_size=cfg_get(config, "deployment.batch_size", 64),
            device=self.device)

        ab = config.get("ablation", {})
        self.ablate_gnn = ab.get("disable_gnn", False)

        kf = config.get("keyframe", {})
        self.selector = KeyframeSelector(
            distance_threshold=kf.get("distance_threshold", 0.5),
            rotation_threshold=kf.get("rotation_threshold", 15.0),
            overlap_threshold=kf.get("overlap_threshold", 0.7),
            temporal_threshold=kf.get("temporal_threshold", 5.0),
            voxel_size=kf.get("voxel_size", 0.2),
            max_keyframes=kf.get("max_keyframes", 100_000))
        self.temporal_neighbors = (0 if ab.get("disable_temporal_edges",
                                               False)
                                   else kf.get("temporal_neighbors", 5))

        g = config.get("gnn", {})
        self.model = create_spectral_gnn(
            input_dim=g.get("input_dim", self.encoder_config.output_dim),
            hidden_dim=g.get("hidden_dim", 256),
            output_dim=g.get("output_dim", self.encoder_config.output_dim),
            n_layers=g.get("n_layers", 3), dropout=g.get("dropout", 0.1),
            residual=g.get("residual", True), edge_dim=g.get("edge_dim", 2),
            mixed_precision=cfg_get(config, "training.mixed_precision",
                                    g.get("mixed_precision", False)))

    @contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stage_seconds[name] += time.perf_counter() - t0

    def _process_sequence(self, loader, sequence_id: int = 0,
                          selector: Optional[KeyframeSelector] = None
                          ) -> List[Keyframe]:
        """Select keyframes from a loader (indexed scan by scan) and attach
        their descriptors, encoded in device batches. Scans that raise are
        logged and skipped; with ``quality.validate_poses`` so are scans
        whose pose is not SE(3)."""
        sel = selector or self.selector
        new_kfs: List[Keyframe] = []
        new_ring_ids: List[Optional[np.ndarray]] = []
        n_skipped = 0
        check_poses = cfg_get(self.config, "quality.validate_poses", False)
        with self._stage(f"select_seq{sequence_id}"):
            for scan_id in range(len(loader)):
                try:
                    frame = loader[scan_id]
                    if check_poses and not is_valid_transformation(
                            np.asarray(frame["pose"], np.float64)):
                        n_skipped += 1
                        logger.warning("Skipping scan %d: invalid SE(3) "
                                       "pose", scan_id)
                        continue
                    selected, kf, _ = sel.process_scan(
                        scan_id, frame["points"], frame["pose"],
                        frame["timestamp"], sequence_id=sequence_id)
                except Exception as e:
                    n_skipped += 1
                    logger.warning("Skipping scan %d: %s", scan_id, e)
                    continue
                if selected:
                    new_kfs.append(kf)
                    new_ring_ids.append(frame.get("ring_ids"))
        if n_skipped:
            logger.warning("Sequence %d: skipped %d scans", sequence_id,
                           n_skipped)
        with self._stage(f"encode_seq{sequence_id}"):
            if new_kfs:
                desc = self.encoder.encode([kf.points for kf in new_kfs],
                                           ring_ids=new_ring_ids)
                for kf, d in zip(new_kfs, desc):
                    kf.descriptor = d
        logger.info("Sequence %d: %d scans -> %d keyframes", sequence_id,
                    len(loader), len(new_kfs))
        return new_kfs

    def train_offline(self, train_loaders: Sequence,
                      val_loaders: Sequence = (),
                      n_epochs: Optional[int] = None,
                      resume: Optional[str] = None) -> GNNTrainer:
        """Select → encode → graph → train; returns the trainer, whose
        model (``self.model``) holds the trained weights."""
        if self.ablate_gnn:
            raise ValueError("ablation.disable_gnn is set: there is no GNN "
                             "to train")
        tr = self.config.get("training", {})
        trip = self.config.get("triplet", {})

        train_kfs: List[Keyframe] = []
        for i, loader in enumerate(train_loaders):
            train_kfs.extend(self._process_sequence(loader, sequence_id=i))
        if not train_kfs:
            raise ValueError("No training keyframes selected")
        crit = self.selector.criteria
        val_selector = KeyframeSelector(
            distance_threshold=crit.distance_threshold,
            rotation_threshold=crit.rotation_threshold,
            overlap_threshold=crit.overlap_threshold,
            temporal_threshold=crit.temporal_threshold)
        val_kfs: List[Keyframe] = []
        for j, loader in enumerate(val_loaders):
            val_kfs.extend(self._process_sequence(
                loader, sequence_id=1000 + j, selector=val_selector))

        with self._stage("build_graph"):
            train_graph = build_graph_from_keyframes(
                train_kfs, temporal_neighbors=self.temporal_neighbors)
            val_graph = (build_graph_from_keyframes(
                val_kfs, temporal_neighbors=self.temporal_neighbors)
                if val_kfs else None)

        trainer = GNNTrainer(
            model=self.model,
            learning_rate=tr.get("learning_rate", 5e-4),
            weight_decay=tr.get("weight_decay", 1e-5),
            margin=trip.get("margin", 0.1),
            grad_clip=tr.get("grad_clip", 1.0),
            checkpoint_dir=cfg_get(self.config, "system.checkpoint_dir",
                                   "checkpoints"),
            patience=tr.get("patience", 10),
            triplets_per_step=tr.get("triplets_per_step", 4096),
            seed=cfg_get(self.config, "system.seed", 42),
            lr_decay_epochs=tr.get("lr_decay_epochs"),
            lr_decay_factor=tr.get("lr_decay_factor", 0.1),
            min_lr=tr.get("min_lr", 1e-6),
            normalize_embeddings=tr.get("normalize_embeddings", False),
            device=self.device)
        miner = create_triplet_miner(
            positive_distance_max=trip.get("positive_distance_max", 5.0),
            negative_distance_min=trip.get("negative_distance_min", 10.0),
            negative_distance_max=trip.get("negative_distance_max", 50.0),
            positive_temporal_min=trip.get("positive_temporal_min", 30),
            negative_temporal_min=trip.get(
                "negative_temporal_min", trip.get("positive_temporal_min",
                                                  30)),
            mining_strategy=trip.get("mining_strategy", "hard"),
            device=self.device)
        if resume:
            trainer.load_checkpoint(resume)
        poses = np.array([kf.pose for kf in train_kfs])
        seq_ids = np.array([kf.sequence_id for kf in train_kfs])
        val_poses = (np.array([kf.pose for kf in val_kfs])
                     if val_kfs else None)

        ckpt = self.config.get("checkpoint", {})
        with self._stage("train"):
            trainer.train(
                train_graph=train_graph, train_poses=poses,
                train_descriptors=train_graph.features,
                train_sequence_ids=seq_ids, val_graph=val_graph,
                val_poses=val_poses,
                n_epochs=n_epochs or tr.get("n_epochs", 50),
                triplet_miner=miner,
                early_stopping=tr.get("early_stopping", True),
                n_triplets_per_anchor=trip.get("n_negatives_per_anchor", 1),
                recall_ks=cfg_get(self.config, "validation.recall_k_values",
                                  [1, 5, 10]),
                save_best=ckpt.get("save_best", True),
                save_last=ckpt.get("save_last", True))
        logger.info("Stage seconds: %s",
                    {k: round(v, 3) for k, v in self.stage_seconds.items()})
        return trainer
