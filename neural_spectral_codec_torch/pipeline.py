"""Config-driven pipeline of the port (``neural_spectral_codec_tpu/
pipeline.py``): the batch encoders (``BatchEncoder`` and
``RingMajorBatchEncoder``, JAX :79-229), ``NeuralSpectralCodecPipeline``
(offline training: ``_process_sequence`` and ``train_offline``; the online
loop: ``run_online``), and the CLI (``_loaders_from_config``,
``run_pipeline``, ``main``):

    python -m neural_spectral_codec_torch.pipeline --config C \\
        --mode {train,online} [--device cuda|cpu]

Scans are read through ``data.native_io.frame_source`` (native read-ahead
as ``system.io_prefetch`` allows). On a CUDA device the general encoder
launches ``csrc/project.cu`` and ``csrc/spectral.cu``, the ring-major
encoder ``csrc/ring_fold.cu`` and ``csrc/spectral.cu`` for the scans that
meet the ring contract. The pipeline takes a config dict
(``utils.config.load_config`` reads one from YAML). ``training.
mixed_precision`` computes the GNN in bf16, in training and serving.
With more than one device of the pipeline's type, ``parallel.
data_parallel`` (default on) trains over a mesh of ``system.mesh_devices``
devices (``parallel.shard_graph_nodes``: nodes sharded too) and
``parallel.shard_retrieval_db`` row-shards the stage-1 database; with
one, both keep the single device (the latter with a warning), as in the
JAX package.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from neural_spectral_codec_torch.data.native_io import frame_source
from neural_spectral_codec_torch.data.pose_utils import (
    is_valid_transformation)
from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.keyframe.graph import (
    TemporalGraphManager, build_graph_from_keyframes, graph_to_tensors,
    pad_graph)
from neural_spectral_codec_torch.keyframe.selector import (
    Keyframe, KeyframeSelector)
from neural_spectral_codec_torch.models import gnn, serving
from neural_spectral_codec_torch.models.gnn import (
    LocalUpdateGNN, create_spectral_gnn, gnn_forward)
from neural_spectral_codec_torch.ops.range_image import pad_points
from neural_spectral_codec_torch.ops.spectral import (
    SpectralEncoderConfig, encode_points_batch)
from neural_spectral_codec_torch.retrieval.g2o import save_loop_closures_g2o
from neural_spectral_codec_torch.retrieval.two_stage import TwoStageRetrieval
from neural_spectral_codec_torch.training.miner import create_triplet_miner
from neural_spectral_codec_torch.training.trainer import GNNTrainer
from neural_spectral_codec_torch.utils.config import get as cfg_get
from neural_spectral_codec_torch.utils.config import load_config
from neural_spectral_codec_torch.utils.profiler import Profiler

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
        return self.encode([cloud], ring_ids=None if ring_ids is None
                           else [ring_ids])[0]


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
    """Config-driven wiring of every layer on ``device``.
    ``stage_seconds`` holds host-clock seconds per stage of offline
    training (selection and encoding per sequence, graph build,
    training); ``profiler`` the online loop's stage times."""

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

        self.graph_manager = TemporalGraphManager(
            temporal_neighbors=self.temporal_neighbors,
            max_active_nodes=kf.get("max_active_nodes", 1000),
            freeze_old_embeddings=kf.get("freeze_old_embeddings", True))

        g = config.get("gnn", {})
        self.model = create_spectral_gnn(
            input_dim=g.get("input_dim", self.encoder_config.output_dim),
            hidden_dim=g.get("hidden_dim", 256),
            output_dim=g.get("output_dim", self.encoder_config.output_dim),
            n_layers=g.get("n_layers", 3), dropout=g.get("dropout", 0.1),
            residual=g.get("residual", True), edge_dim=g.get("edge_dim", 2),
            mixed_precision=cfg_get(config, "training.mixed_precision",
                                    g.get("mixed_precision", False)))
        # True once train_offline or load_checkpoint set the weights
        self.weights_loaded = False
        self.local_update_hops = g.get("local_update_hops", 3)
        self.use_local_updates = g.get("use_local_updates", True)

        r = config.get("retrieval", {})
        # retrieval.use_embeddings: stage 1 ranks GNN embeddings by L2
        # instead of raw histograms by W1
        self.use_embeddings_for_retrieval = r.get("use_embeddings", False)
        if self.ablate_gnn and self.use_embeddings_for_retrieval:
            logger.warning("ablation.disable_gnn: retrieval.use_embeddings "
                           "has no embeddings to use; using raw W1 "
                           "histograms")
            self.use_embeddings_for_retrieval = False
        retrieval_mesh = None
        if cfg_get(config, "parallel.shard_retrieval_db", False):
            retrieval_mesh = self._mesh("parallel.shard_retrieval_db")
            if retrieval_mesh is None:
                logger.warning("parallel.shard_retrieval_db requested but "
                               "only one device present; using the "
                               "unsharded retriever")
        stage1_metric = ("l2" if (self.use_embeddings_for_retrieval
                                  or not r.get("use_wasserstein", True))
                         else "wasserstein")
        stage1_storage = r.get("storage", "float32")
        if stage1_metric != "wasserstein" and stage1_storage != "float32":
            logger.warning("retrieval.storage=%s requires the W1 metric; "
                           "using float32 rows", stage1_storage)
            stage1_storage = "float32"
        self.retrieval = TwoStageRetrieval(
            stage1_metric=stage1_metric, stage1_storage=stage1_storage,
            top_k=r.get("top_k", 10),
            # loop_closing.min_loop_distance is the reference's name for
            # the stage-1 spatial exclusion radius
            spatial_filter_distance=r.get(
                "spatial_filter_distance",
                cfg_get(config, "loop_closing.min_loop_distance", 50.0)),
            context_window=(0 if ab.get("disable_context", False)
                            else r.get("context_window", 10)),
            fitness_threshold=r.get("icp_fitness_threshold", 0.3),
            rmse_threshold=r.get("icp_rmse_threshold", 0.5),
            verification_method=r.get("verification_method", "gicp"),
            n_bins=self.encoder_config.output_dim,
            capacity=r.get("database_capacity",
                           cfg_get(config, "database.max_database_size",
                                   100_000)),
            icp_max_iterations=r.get("icp_max_iterations", 30),
            voxel_downsample=r.get("voxel_downsample", 0.3),
            verification_max_points=r.get("verification_max_points", 4096),
            verification_backend=r.get("verification_backend", "auto"),
            parallel_verification=r.get("parallel_verification", False),
            verification_workers=r.get("verification_workers", 4),
            device=self.device, mesh=retrieval_mesh)
        self.profiler = Profiler()

    def _mesh(self, key: str):
        """A mesh over ``system.mesh_devices`` devices of the pipeline's
        device type (all by default) when that type has more than one
        device, else None (JAX ``pipeline.py:323-333,465-469``)."""
        from neural_spectral_codec_torch.parallel import mesh as pmesh
        if len(pmesh.devices_of(self.device.type)) < 2:
            return None
        mesh = pmesh.create_mesh(cfg_get(self.config, "system.mesh_devices"),
                                 device=self.device.type)
        logger.info("%s: mesh over %s", key, [str(d) for d in mesh.devices])
        return mesh

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
        """Select keyframes from a loader (read scan by scan through
        ``frame_source``) and attach their descriptors, encoded in device
        batches. Scans that raise are logged and skipped; with
        ``quality.validate_poses`` so are scans whose pose is not SE(3)."""
        sel = selector or self.selector
        new_kfs: List[Keyframe] = []
        new_ring_ids: List[Optional[np.ndarray]] = []
        n_skipped = 0
        check_poses = cfg_get(self.config, "quality.validate_poses", False)
        with frame_source(loader, self.config) as get_frame, \
                self._stage(f"select_seq{sequence_id}"):
            for scan_id in range(len(loader)):
                try:
                    frame = get_frame(scan_id)
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

        mesh = (self._mesh("parallel.data_parallel")
                if cfg_get(self.config, "parallel.data_parallel", True)
                else None)
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
            device=self.device if mesh is None else mesh.devices[0],
            mesh=mesh, shard_nodes=cfg_get(
                self.config, "parallel.shard_graph_nodes", False))
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
        self.weights_loaded = True
        return trainer

    # ------------------------------------------------------------------
    # online loop closing
    # ------------------------------------------------------------------

    def load_checkpoint(self, path: str) -> None:
        """Load GNN weights from a checkpoint of the port's trainer: a
        ``.pt`` file (``training/trainer.py`` ``save_checkpoint``), given
        with or without its suffix. An Orbax checkpoint directory of the
        JAX package raises: the port reads no Orbax; convert it first with
        ``convert_orbax_checkpoint.py`` (where jax and orbax are
        installed) into such a ``.pt``."""
        p = Path(path)
        if p.suffix != ".pt" and p.with_suffix(".pt").exists():
            p = p.with_suffix(".pt")
        if p.is_dir():
            raise NotImplementedError(
                f"{path} is a directory (an Orbax checkpoint of the JAX "
                "package?): the port reads .pt checkpoints only; convert it "
                f"with `python convert_orbax_checkpoint.py {path} "
                f"{Path(path).name}.pt` where jax and orbax are installed")
        if not p.exists():
            raise FileNotFoundError(f"Checkpoint not found: {path}")
        state = torch.load(p, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["model"] if "model" in state
                                   else state)
        self.weights_loaded = True
        logger.info("Loaded GNN checkpoint from %s", p)

    def _serving_model(self):
        self.model.to(self.device).eval()
        return self.model

    def warmup(self) -> None:
        """Make the first keyframe as fast as the rest (JAX pipeline.py
        ``warmup``): build the CUDA kernels and the geometry library,
        encode once at B=1, then replay a short session on a scratch graph
        manager (loop edges included) through the executable the hot path
        runs, at every padded bucket it reaches, every smaller one it
        skips and one bucket beyond, and run the stage-1 query once (a
        row-sharded database on one card: its sharded query step, so no
        query graph is captured mid-stream either). With one-dispatch serving
        (``deployment.fused_query``) that executable is the serving step,
        built (on a card: captured) by scratch executions that leave the
        database as it was (``LocalUpdateGNN.warm_serve``); with
        ``fused_encode`` alone the fused encode + refresh; else the split
        local forward. The verifier is warmed too
        (``GeometricVerifier.warmup``): the native library built, or for
        the torch backend its registration executable built (on a card
        captured) on a scratch pair of clouds. The live database and graph
        are left as they were. Run it before the verifier's worker threads
        start."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from neural_spectral_codec_torch import _build
            _build.load_library()
        self.retrieval.verifier.warmup()
        self.encoder.encode_one(np.zeros((64, 4), np.float32))
        if not self.ablate_gnn:
            fused = self.use_local_updates and cfg_get(
                self.config, "deployment.fused_encode", True)
            one_dispatch = fused and cfg_get(
                self.config, "deployment.fused_query", True) \
                and self.retrieval.can_fuse_serving()
            mgr = TemporalGraphManager(
                temporal_neighbors=self.temporal_neighbors,
                max_active_nodes=self.graph_manager.max_active_nodes)
            local = LocalUpdateGNN(self._serving_model(),
                                   k_hops=self.local_update_hops)
            dim = self.encoder_config.output_dim
            desc = np.full(dim, 1.0 / dim, np.float32)
            dummy_pts = pad_points(np.zeros((0, 4), np.float32),
                                   self.encoder.max_points)
            args = (dummy_pts, self.encoder.alpha, self.encoder_config)
            warmed = set()

            def refresh(node, n_slots=None):
                sub, _ = mgr.get_local_subgraph(node, self.local_update_hops)
                bucket = n_slots or local.bucket(sub.n_nodes)
                if one_dispatch:
                    if bucket not in warmed:
                        local.warm_serve(mgr, node, *args, self.retrieval,
                                         bucket)
                elif fused:
                    local.encode_update_local(mgr, node, *args, n_slots)
                elif n_slots is None:
                    local.update_embeddings_local(mgr, node)
                else:
                    local.forward_full(pad_graph(sub, n_slots))
                warmed.add(bucket)

            node = 0
            for i in range(18):
                node = mgr.add_keyframe(Keyframe(
                    keyframe_id=i, scan_id=i, timestamp=float(i),
                    pose=np.eye(4, dtype=np.float32), points=None,
                    descriptor=desc.copy()))
                refresh(node)
            # loop edges widen the k-hop subgraph into the next bucket
            mgr.add_loop_closure_edge(17, 0)
            mgr.add_loop_closure_edge(17, 8)
            refresh(node)
            # a live session whose loop edges inflate the subgraph past the
            # replayed sizes would build mid-stream: one bucket beyond, and
            # every bucket below it that the replay skipped (its subgraphs
            # jump from 8 nodes to past 16 when the loop edges land), each
            # from a scratch subgraph that fits it
            sub, _ = mgr.get_local_subgraph(node, self.local_update_hops)
            top = 2 * local.bucket(sub.n_nodes)
            sizes = {n: len(mgr.get_k_hop_neighbors(
                n, self.local_update_hops)) for n in range(len(mgr.keyframes))}
            for bucket in (8 << i for i in range(top.bit_length() - 3)):
                fits = [n for n, k in sizes.items() if k <= bucket]
                if bucket not in warmed and fits:
                    refresh(fits[0], bucket)
        self.retrieval.retriever.warm_query(self.retrieval.top_k)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.perf_counter() - t0
        logger.info("warmup: serving ready in %.1f s", self.warmup_seconds)

    def run_online(self, loader, checkpoint_path: Optional[str] = None,
                   loop_closure_interval: int = 10,
                   output_g2o: Optional[str] = None,
                   database_path: Optional[str] = None,
                   resume_database: bool = False,
                   async_loop_closing: Optional[bool] = None) -> List[Dict]:
        """Streaming loop closing over ``loader`` (read scan by scan
        through ``frame_source``); returns the verified loop-closure edges
        as g2o edge dicts.

        Every ``loop_closure_interval``-th keyframe queries. With
        ``database_path`` the record store is written at the end (or
        appended every ``database.autosave_interval`` keyframes), and with
        ``resume_database`` an existing store there is loaded first: its
        records serve stage 1 (they carry no points, so candidates against
        them stay unverified) and the new keyframes are numbered after
        them, so a keyframe id is its database row.

        ``async_loop_closing`` (default ``deployment.async_loop_closing``)
        moves loop closing to one background worker: after a one-dispatch
        serving step only verification, else stage 1 against the
        submit-time snapshot of the database and verification. Finished
        edges are applied to the graph as they come and all are drained
        before returning, so the edge set equals the synchronous one; an
        edge whose query keyframe left the active window first is still
        returned but counted in ``self._n_graph_edge_misses``."""
        self._n_graph_edge_misses = 0
        db_base = 0
        if (resume_database and database_path
                and Path(database_path).exists()):
            db_base = self.retrieval.load_database(database_path)
            self.selector.keyframe_id_counter = db_base
            logger.info("Resumed descriptor database: %d records from %s",
                        db_base, database_path)
        autosave_iv = cfg_get(self.config, "database.autosave_interval", 0)
        db_persisted = db_base
        if database_path and autosave_iv:
            file_records = self.retrieval.database_file_records(database_path)
            if db_base != file_records:
                if resume_database and file_records:
                    # a capacity-clipped resume: appending would duplicate
                    # the records that were not loaded
                    logger.warning(
                        "autosave disabled: store has %d records but %d "
                        "were resumed (capacity clip); will rewrite on "
                        "finish", file_records, db_base)
                    autosave_iv = 0
                elif file_records:
                    Path(database_path).unlink()   # a stale store
        mon = self.config.get("monitoring", {})
        mon_enabled = mon.get("enabled", False)
        mon_interval = mon.get("log_interval", 100)
        max_latency_ms = cfg_get(self.config, "deployment.max_latency_ms",
                                 None)
        if checkpoint_path:
            self.load_checkpoint(checkpoint_path)
        if not self.weights_loaded and not self.ablate_gnn:
            logger.warning("Running online with randomly initialized GNN")
        if cfg_get(self.config, "deployment.warmup", False):
            self.warmup()
        local_gnn = (None if self.ablate_gnn else
                     LocalUpdateGNN(self._serving_model(),
                                    k_hops=self.local_update_hops))
        if async_loop_closing is None:
            async_loop_closing = cfg_get(
                self.config, "deployment.async_loop_closing", False)
        executor = None
        pending: List = []    # (query keyframe_id, Future[List[Dict]])
        if async_loop_closing:
            from concurrent.futures import ThreadPoolExecutor
            executor = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="loop-closing")
        all_loop_closures: List[Dict] = []
        n_queries = 0
        dev = self.device
        ret = self.retrieval.retriever

        def _apply_edges(query_id: int, edges: List[Dict]) -> None:
            n_missed = sum(not self.graph_manager.add_loop_closure_edge(
                query_id, e["target_id"]) for e in edges)
            if n_missed:
                self._n_graph_edge_misses += n_missed
                logger.warning(
                    "query kf %d: %d/%d loop-closure edges not inserted "
                    "into the GNN graph (endpoint frozen out of the active "
                    "window before harvest)", query_id, n_missed, len(edges))
            if edges:
                all_loop_closures.extend(edges)
                logger.info("query kf %d: %d loop closures", query_id,
                            len(edges))

        def _harvest(block: bool = False) -> None:
            remaining = []
            for query_id, fut in pending:
                if block or fut.done():
                    _apply_edges(query_id, fut.result())
                else:
                    remaining.append((query_id, fut))
            pending[:] = remaining

        verifier = self.retrieval.verifier

        def _captures_counted(fn, *args):
            # registration and query graphs captured during the stream
            # (warmup() captures them ahead)
            captures = verifier.captures, ret.captures
            out = fn(*args)
            for event, before, now in (
                    ("verifier_midstream_captures", captures[0],
                     verifier.captures),
                    ("query_midstream_captures", captures[1], ret.captures)):
                if now != before:
                    self.profiler.count(event, now - before)
            return out

        def _verify(kf, cands):
            with self.profiler.profile("verification"):
                return _captures_counted(
                    self.retrieval.loop_closures_from_candidates, kf, cands,
                    kf.points)

        def _check_budget(scan_id: int, t0: float) -> None:
            query_ms = 1e3 * (time.perf_counter() - t0)
            if max_latency_ms and query_ms > max_latency_ms:
                logger.warning("scan %d: loop-closing latency %.1f ms "
                               "exceeds budget %.0f ms", scan_id, query_ms,
                               max_latency_ms)

        fused = ((not self.ablate_gnn) and self.use_local_updates and
                 cfg_get(self.config, "deployment.fused_encode", True))
        one_dispatch = fused and cfg_get(self.config,
                                         "deployment.fused_query", True)
        placeholder = np.zeros(self.encoder_config.output_dim, np.float32)

        def _graph_counts() -> tuple:
            return (serving.STATS["replays"], gnn.STATS["replays"],
                    serving.STATS["captures"] + gnn.STATS["captures"])

        def _count_graphs(scan_id: int, before: tuple) -> None:
            # the keyframe's serving- and eval-graph replays, and any graph
            # captured during the stream: its capture's time lands on this
            # keyframe (warmup() captures them ahead)
            now = _graph_counts()
            self.profiler.count("serving_replays", now[0] - before[0])
            self.profiler.count("eval_replays", now[1] - before[1])
            if now[2] != before[2]:
                self.profiler.count("midstream_captures", now[2] - before[2])
                logger.warning("scan %d: %d serving or eval graph(s) "
                               "captured mid-stream", scan_id,
                               now[2] - before[2])
        try:
            with frame_source(loader, self.config) as get_frame:
                for scan_id in range(len(loader)):
                    frame = get_frame(scan_id)
                    with self.profiler.profile("select"):
                        selected, kf, _ = self.selector.process_scan(
                            scan_id, frame["points"], frame["pose"],
                            frame["timestamp"])
                    if not selected:
                        continue
                    will_query = (len(self.selector.keyframes)
                                  % loop_closure_interval == 0)
                    stage1 = None
                    fused_inserted = False
                    t_step = time.perf_counter()
                    graphs_before = _graph_counts()
                    if one_dispatch and self.retrieval.can_fuse_serving():
                        with self.profiler.profile("serve_step", sync=dev):
                            kf.descriptor = placeholder
                            node = self.graph_manager.add_keyframe(kf)
                            pos = (kf.pose[:3, 3] if kf.pose is not None
                                   else None)
                            # padded into the executable's staging buffer
                            desc, refreshed_nodes, stage1 = \
                                local_gnn.serve_step(
                                    self.graph_manager, node, kf.points,
                                    self.encoder.alpha, self.encoder_config,
                                    self.retrieval, will_query,
                                    query_pose_position=pos,
                                    n_points=self.encoder.max_points)
                            kf.descriptor = desc
                            fused_inserted = True
                    elif fused:
                        with self.profiler.profile("encode_graph_update",
                                                   sync=dev):
                            kf.descriptor = placeholder
                            node = self.graph_manager.add_keyframe(kf)
                            desc, refreshed_nodes = \
                                local_gnn.encode_update_local(
                                    self.graph_manager, node, kf.points,
                                    self.encoder.alpha, self.encoder_config,
                                    n_points=self.encoder.max_points)
                            kf.descriptor = desc
                    else:
                        with self.profiler.profile("encode", sync=dev):
                            kf.descriptor = self.encoder.encode_one(
                                kf.points, ring_ids=frame.get("ring_ids"))
                        with self.profiler.profile("graph_update", sync=dev):
                            node = self.graph_manager.add_keyframe(kf)
                            refreshed_nodes = []
                            if self.ablate_gnn:
                                pass    # raw histograms go to retrieval as is
                            elif self.use_local_updates:
                                refreshed_nodes = \
                                    local_gnn.update_embeddings_local(
                                        self.graph_manager, node)
                            else:
                                # the whole graph grows by a node a
                                # keyframe: op by op (gnn.STATS counts it)
                                emb = gnn_forward(
                                    local_gnn.model, graph_to_tensors(
                                        self.graph_manager.get_graph(),
                                        local_gnn.device)).cpu().numpy()
                                self.graph_manager.update_embeddings(emb)
                                refreshed_nodes = list(range(len(
                                    self.graph_manager.keyframes)))
                    _count_graphs(scan_id, graphs_before)
                    if (database_path and autosave_iv and
                            len(self.retrieval.keyframes) - db_persisted
                            >= autosave_iv):
                        with self.profiler.profile("db_autosave"):
                            db_persisted = self.retrieval.append_database(
                                database_path, db_persisted)
                    with self.profiler.profile("retrieval_add", sync=dev):
                        if fused_inserted:
                            self.retrieval.register_fused_insert(kf)
                        else:
                            self.retrieval.add_keyframe(kf)
                        if (self.use_embeddings_for_retrieval
                                and refreshed_nodes):
                            # db row == keyframe_id (ids continue after a
                            # resumed store)
                            self.retrieval.refresh_keyframes([
                                self.graph_manager.keyframes[i].keyframe_id
                                for i in refreshed_nodes])

                    if will_query:
                        n_queries += 1
                        if stage1 is not None:
                            # stage 1 ran inside the serving step
                            cands = self.retrieval.candidates_from_stage1(
                                *stage1)
                            if executor is not None:
                                with self.profiler.profile(
                                        "loop_closing_submit"):
                                    pending.append((kf.keyframe_id,
                                                    executor.submit(
                                                        _verify, kf, cands)))
                            else:
                                with self.profiler.profile("loop_closing"):
                                    edges = _verify(kf, cands)
                                # the budget counts the serving step that ran
                                # stage 1, and the verification
                                _check_budget(scan_id, t_step)
                                _apply_edges(kf.keyframe_id, edges)
                        elif executor is not None:
                            with self.profiler.profile("loop_closing_submit"):
                                # the size read and the enqueue under one lock:
                                # the worker queries the database as it stood
                                # at submit time
                                with ret._buffer_lock:
                                    snapshot = ret.database_size
                                    pending.append((kf.keyframe_id,
                                                    executor.submit(
                                        _captures_counted,
                                        self.retrieval.get_loop_closures, kf,
                                        kf.points, snapshot)))
                        else:
                            with self.profiler.profile("loop_closing"):
                                t0 = time.perf_counter()
                                edges = _captures_counted(
                                    self.retrieval.get_loop_closures, kf,
                                    kf.points)
                            _check_budget(scan_id, t0)
                            _apply_edges(kf.keyframe_id, edges)
                    if executor is not None:
                        _harvest()

                    if mon_enabled and (scan_id + 1) % mon_interval == 0:
                        self._log_monitor(scan_id, mon)
        finally:
            if executor is not None:
                try:
                    _harvest(block=True)
                finally:
                    executor.shutdown(wait=True)
        if database_path:
            if autosave_iv:
                n = self.retrieval.append_database(database_path,
                                                   db_persisted)
            else:
                n = self.retrieval.save_database(database_path)
            logger.info("Saved %d descriptor records to %s", n, database_path)
        if output_g2o and all_loop_closures:
            save_loop_closures_g2o(all_loop_closures, output_g2o)
            logger.info("Saved %d loop-closure edges to %s",
                        len(all_loop_closures), output_g2o)
        self.profiler.log_summary()
        logger.info("Online run: %d scans, %d keyframes, %d queries, "
                    "%d loop closures", len(loader),
                    len(self.selector.keyframes), n_queries,
                    len(all_loop_closures))
        return all_loop_closures

    def _log_monitor(self, scan_id: int, mon: Dict) -> None:
        means = self.profiler.means_ms()
        mem = ""
        if ("memory_usage" in mon.get("metrics", ())
                and self.device.type == "cuda"):
            mem = (f" | mem {torch.cuda.memory_allocated(self.device) / 2**20:.0f}"
                   f" MiB")
        logger.info(
            "monitor @%d | %s | db=%d%s", scan_id + 1,
            " | ".join(f"{k} {means[k]:.2f} ms/call"
                       for k in ("select", "encode", "graph_update",
                                 "encode_graph_update", "serve_step",
                                 "db_autosave", "loop_closing",
                                 "loop_closing_submit", "verification")
                       if k in means),
            self.retrieval.retriever.database_size, mem)


def _loaders_from_config(config: Dict, split: str) -> List:
    """The dataset loaders of a config split, ``data.datasets.<split>``
    (kitti, nclt, helipr, synthetic; JAX pipeline.py:1020)."""
    from neural_spectral_codec_torch.data.multi_dataset import _make_loader
    out = []
    for ds in cfg_get(config, f"data.datasets.{split}", []) or []:
        for seq in ds.get("sequences", []):
            out.append(_make_loader(ds["type"], ds["root"], str(seq),
                                    ds.get("lazy_load", True)))
    return out


def run_pipeline(config_path: str, mode: str = "train",
                 device: DeviceLike = "cuda"):
    """CLI body (JAX pipeline.py:1033): ``train`` trains on the config's
    train and val splits and returns the trainer; ``online`` runs
    ``run_online`` over each test (else val) sequence, with the loop
    closures exported as g2o, and returns the pipeline."""
    config = load_config(config_path)
    pipeline = NeuralSpectralCodecPipeline(config, device=device)
    if mode == "train":
        return pipeline.train_offline(
            _loaders_from_config(config, "train"),
            _loaders_from_config(config, "val"))
    if mode != "online":
        raise ValueError(f"Unknown mode: {mode}")
    loaders = (_loaders_from_config(config, "test")
               or _loaders_from_config(config, "val"))
    ckpt = cfg_get(config, "model.checkpoint_path")
    # g2o is the only edge format; any other value disables the export
    # rather than mislabel it
    fmt = cfg_get(config, "loop_closing.output_format", "g2o")
    out = (cfg_get(config, "loop_closing.output_path",
                   "outputs/loop_closures.g2o") if fmt == "g2o" else None)
    if fmt != "g2o":
        logger.warning("loop_closing.output_format=%s not supported; edge "
                       "export disabled (only g2o)", fmt)
    for loader in loaders:
        pipeline.run_online(
            loader, checkpoint_path=ckpt,
            loop_closure_interval=cfg_get(
                config, "deployment.loop_closing_interval", 10),
            output_g2o=out,
            database_path=cfg_get(config, "database.storage_path"))
    return pipeline


def main(argv=None):
    """``python -m neural_spectral_codec_torch.pipeline --config C --mode
    {train,online} [--device cuda|cpu]``. Returns what ``run_pipeline``
    returns."""
    import argparse

    from neural_spectral_codec_torch.utils.logging_setup import (
        setup_logging)
    p = argparse.ArgumentParser(
        description="Neural Spectral Codec (PyTorch port)")
    p.add_argument("--config", required=True)
    p.add_argument("--mode", default="train", choices=["train", "online"])
    p.add_argument("--device", default="cuda",
                   help="'cuda[:N]' (default) or 'cpu'; no fallback")
    args = p.parse_args(argv)
    setup_logging()
    return run_pipeline(args.config, args.mode, device=args.device)


if __name__ == "__main__":
    main()
