"""Two-stage loop closing: stage 1 is the device-side W₁ (or L2) top-k
with the spatial filter and the temporal-context exclusion, stage 2 the
geometric verification of its candidates. Port of
``neural_spectral_codec_tpu/retrieval/two_stage.py``, with
its fixed-size record store (``save_database``, ``append_database``,
``load_database``; records byte-identical to the JAX package's).
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from neural_spectral_codec_torch.device import DeviceLike
from neural_spectral_codec_torch.keyframe.selector import Keyframe
from neural_spectral_codec_torch.retrieval.g2o import compute_pose_graph_edge
from neural_spectral_codec_torch.retrieval.retriever import (
    WassersteinRetriever)
from neural_spectral_codec_torch.retrieval.verification import (
    GeometricVerifier, PreparedCloud)

logger = logging.getLogger(__name__)

_LOAD_CHUNK = 8192   # records per device insert when loading a store


@dataclass
class LoopClosureCandidate:
    database_idx: int
    distance: float  # stage-1 distance
    verified: bool = False
    transform: Optional[np.ndarray] = None
    fitness: Optional[float] = None
    rmse: Optional[float] = None
    information_matrix: Optional[np.ndarray] = None


class TwoStageRetrieval:
    """Stage-1 database and stage-2 verifier of the online loop.

    ``device`` holds the stage-1 database (and the verifier's tensors
    under ``verification_backend="torch"``); a ``mesh``
    (``parallel.Mesh``) row-shards the database over its devices instead
    (``parallel.ShardedWassersteinRetriever``, the pipeline's
    ``parallel.shard_retrieval_db``). ``stage1_storage="uint16"`` stores
    the CDF rows as fixed-point codes (W₁ only)."""

    def __init__(self, top_k: int = 10, spatial_filter_distance: float = 50.0,
                 context_window: int = 10, fitness_threshold: float = 0.3,
                 rmse_threshold: float = 0.5, verification_method: str = "gicp",
                 n_bins: int = 800, capacity: int = 100_000,
                 icp_max_iterations: int = 30, voxel_downsample: float = 0.3,
                 verification_max_points: int = 4096,
                 verification_backend: str = "auto",
                 stage1_metric: str = "wasserstein",
                 stage1_storage: str = "float32",
                 parallel_verification: bool = False,
                 verification_workers: int = 4,
                 device: DeviceLike = "cuda", mesh=None):
        self.top_k = top_k
        self.spatial_filter_distance = spatial_filter_distance
        self.context_window = context_window
        self.stage1_metric = stage1_metric
        if mesh is not None:
            from neural_spectral_codec_torch.parallel.retrieval import (
                ShardedWassersteinRetriever)
            self.retriever = ShardedWassersteinRetriever(
                mesh, n_bins=n_bins, capacity=capacity, metric=stage1_metric,
                storage=stage1_storage)
        else:
            self.retriever = WassersteinRetriever(
                n_bins=n_bins, capacity=capacity, metric=stage1_metric,
                storage=stage1_storage, device=device)
        self.verifier = GeometricVerifier(
            method=verification_method, fitness_threshold=fitness_threshold,
            rmse_threshold=rmse_threshold, max_iterations=icp_max_iterations,
            voxel_downsample=voxel_downsample,
            max_points=verification_max_points,
            backend=verification_backend, device=device)
        # threads verify in parallel only where ctypes releases the GIL
        self.parallel_verification = (parallel_verification
                                      and self.verifier.backend == "native")
        self.verification_workers = verification_workers
        self.keyframes: List[Keyframe] = []
        # verification state per stored keyframe (clouds never change), a
        # FIFO of at most _prep_cache_max entries shared by worker threads
        self._prep_cache: Dict[int, PreparedCloud] = {}
        self._prep_cache_max = 1024
        self._capacity_warned = False
        self._prep_lock = threading.Lock()

    def _stage1_vector(self, keyframe: Keyframe) -> np.ndarray:
        """The L2 metric ranks GNN embeddings when the keyframe has one;
        W₁ always ranks the raw spectral histogram."""
        if self.stage1_metric == "l2" and keyframe.embedding is not None:
            return keyframe.embedding
        return keyframe.descriptor

    def _check_capacity(self) -> bool:
        if self.retriever.database_size < self.retriever.capacity:
            return True
        if not self._capacity_warned:
            logger.warning("stage-1 database full (%d); new keyframes will "
                           "not be retrievable as loop-closure candidates",
                           self.retriever.capacity)
            self._capacity_warned = True
        return False

    def add_keyframe(self, keyframe: Keyframe) -> bool:
        """Insert a keyframe into the stage-1 database. A full database
        returns False without inserting or tracking it, so a long session
        loses new candidates instead of crashing."""
        if keyframe.descriptor is None:
            raise ValueError("Keyframe must have descriptor before adding "
                             "to database")
        if not self._check_capacity():
            return False
        self.keyframes.append(keyframe)
        pos = (keyframe.pose[:3, 3] if keyframe.pose is not None
               else np.zeros(3))
        self.retriever.add_to_database(
            np.asarray(self._stage1_vector(keyframe)).reshape(1, -1),
            np.asarray(pos).reshape(1, 3))
        return True

    def can_fuse_serving(self) -> bool:
        """Whether the one-dispatch serving step may drive this instance:
        a single-device ``WassersteinRetriever`` (the sharded one keeps
        its own insert and query dispatch, as in the JAX package) with a
        free row."""
        return (type(self.retriever) is WassersteinRetriever
                and self.retriever.database_size < self.retriever.capacity)

    def register_fused_insert(self, keyframe: Keyframe) -> None:
        """Track a keyframe whose row the serving step already inserted."""
        if keyframe.descriptor is None:
            raise ValueError("Keyframe must have descriptor")
        self.keyframes.append(keyframe)

    def candidates_from_stage1(self, idx, dist) -> List[LoopClosureCandidate]:
        return [LoopClosureCandidate(int(i), float(d))
                for i, d in zip(idx, dist)]

    def _edge(self, query_keyframe: Keyframe,
              cand: LoopClosureCandidate) -> Dict:
        kf = self.keyframes[cand.database_idx]
        edge = compute_pose_graph_edge(
            source_pose=query_keyframe.pose, target_pose=kf.pose,
            relative_transform=cand.transform,
            information_matrix=cand.information_matrix)
        edge.update({"source_id": query_keyframe.keyframe_id,
                     "target_id": kf.keyframe_id, "fitness": cand.fitness,
                     "rmse": cand.rmse,
                     "wasserstein_distance": cand.distance})
        return edge

    def loop_closures_from_candidates(self, query_keyframe: Keyframe,
                                      candidates: List[LoopClosureCandidate],
                                      query_points: Optional[np.ndarray] = None
                                      ) -> List[Dict]:
        """Stage 2 and the g2o edge dicts for given stage-1 candidates."""
        if not candidates:
            return []
        pts = (query_points if query_points is not None
               else query_keyframe.points)
        return [self._edge(query_keyframe, c)
                for c in self._geometric_verification(pts, candidates)]

    def refresh_keyframes(self, database_indices) -> None:
        """Re-encode inserted rows from their keyframes' current stage-1
        vectors (after the GNN refreshed their embeddings)."""
        idx = [i for i in database_indices if 0 <= i < len(self.keyframes)]
        if not idx:
            return
        vecs = np.stack([self._stage1_vector(self.keyframes[i]) for i in idx])
        self.retriever.update_rows(np.asarray(idx), vecs)

    def query(self, query_keyframe: Keyframe,
              query_points: Optional[np.ndarray] = None, verify: bool = True,
              as_of_size: Optional[int] = None
              ) -> List[LoopClosureCandidate]:
        """Stage 1 (against the snapshot of ``as_of_size`` rows when given)
        and, with ``verify``, stage 2; returns the surviving candidates."""
        if query_keyframe.descriptor is None:
            raise ValueError("Query keyframe must have descriptor")
        candidates = self._global_retrieval(query_keyframe, as_of_size)
        if not candidates:
            return []
        if verify:
            if query_points is None:
                query_points = query_keyframe.points
            candidates = self._geometric_verification(query_points,
                                                      candidates)
        return candidates

    def _global_retrieval(self, query_keyframe: Keyframe,
                          as_of_size: Optional[int] = None
                          ) -> List[LoopClosureCandidate]:
        pos = (query_keyframe.pose[:3, 3]
               if query_keyframe.pose is not None else None)
        idx, dist = self.retriever.query(
            self._stage1_vector(query_keyframe), top_k=self.top_k,
            query_position=pos,
            spatial_min_distance=(self.spatial_filter_distance
                                  if pos is not None else 0.0),
            exclude_last=self.context_window, as_of_size=as_of_size)
        return self.candidates_from_stage1(idx, dist)

    def _keyframe_prep(self, database_idx: int) -> PreparedCloud:
        """Cached verification state of a stored keyframe. The prepare()
        itself runs outside the lock: a rare concurrent miss costs one
        duplicate preparation, never a wrong result."""
        with self._prep_lock:
            prep = self._prep_cache.get(database_idx)
        if prep is None:
            prep = self.verifier.prepare(self.keyframes[database_idx].points)
            with self._prep_lock:
                if database_idx not in self._prep_cache:
                    while len(self._prep_cache) >= self._prep_cache_max:
                        self._prep_cache.pop(next(iter(self._prep_cache)))
                    self._prep_cache[database_idx] = prep
        return prep

    def _geometric_verification(self, query_points: Optional[np.ndarray],
                                candidates: List[LoopClosureCandidate]
                                ) -> List[LoopClosureCandidate]:
        query_prep = (self.verifier.prepare(query_points)
                      if query_points is not None else None)

        def run_one(cand):
            kf = self.keyframes[cand.database_idx]
            if query_prep is None or kf.points is None:
                # records loaded from a store carry no points: the
                # candidate stays unverified
                return False, None, {"fitness": 0.0, "rmse": float("inf"),
                                     "information_matrix": None}
            return self.verifier.verify(
                query_prep, self._keyframe_prep(cand.database_idx))

        if self.parallel_verification and len(candidates) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    max_workers=self.verification_workers) as pool:
                results = list(pool.map(run_one, candidates))
        else:
            results = [run_one(c) for c in candidates]

        verified = []
        for cand, (ok, T, info) in zip(candidates, results):
            cand.verified = ok
            cand.transform = T
            cand.fitness = info["fitness"]
            cand.rmse = info["rmse"]
            cand.information_matrix = info.get("information_matrix")
            if ok:
                verified.append(cand)
        return verified

    def get_loop_closures(self, query_keyframe: Keyframe,
                          query_points: Optional[np.ndarray] = None,
                          as_of_size: Optional[int] = None) -> List[Dict]:
        """Verified loop closures as g2o edge dicts."""
        candidates = self._global_retrieval(query_keyframe, as_of_size)
        return self.loop_closures_from_candidates(
            query_keyframe, candidates, query_points)

    def clear_database(self) -> None:
        self.keyframes.clear()
        self.retriever.clear_database()
        self._capacity_warned = False
        with self._prep_lock:          # cached by database row: stale now
            self._prep_cache.clear()

    # -- persistence: fixed-size records, append-only ---------------------

    def save_database(self, path: str) -> int:
        """Write every keyframe's record to a fresh store; returns the
        record count."""
        if os.path.exists(path):
            os.remove(path)
        return self.append_database(path, 0)

    def append_database(self, path: str, start: int) -> int:
        """Append the records of ``keyframes[start:]`` in one write (a
        crash loses at most this tail; a torn record is dropped on load).
        Returns the persisted count, ``len(self.keyframes)``."""
        from neural_spectral_codec_torch.ops.quantization import (
            compress_descriptors, compute_point_cloud_hash)
        kfs = self.keyframes[start:]
        if kfs:
            empty = np.zeros((0, 3), np.float32)
            data = compress_descriptors(
                np.stack([kf.descriptor for kf in kfs]),
                [kf.pose if kf.pose is not None else np.eye(4) for kf in kfs],
                [kf.timestamp for kf in kfs], [kf.keyframe_id for kf in kfs],
                [compute_point_cloud_hash(kf.points if kf.points is not None
                                          else empty) for kf in kfs])
            with open(path, "ab") as f:
                f.write(data)
        return len(self.keyframes)

    def database_file_records(self, path: str) -> int:
        """Record count currently in the on-disk store (0 if absent)."""
        from neural_spectral_codec_torch.ops.quantization import record_size
        try:
            return os.path.getsize(path) // record_size(self.retriever.n_bins)
        except OSError:
            return 0

    def load_database(self, path: str) -> int:
        """Rebuild the database from a store: its first ``capacity``
        records, inserted in chunks. Loaded keyframes carry dequantised
        descriptors, poses, timestamps and ids but no points, so stage 1
        serves them and stage 2 leaves them unverified."""
        from neural_spectral_codec_torch.ops.quantization import (
            DescriptorDatabaseFile, dequantize_numpy, pose_from_7dof)
        self.clear_database()
        total, codes, p7, ts, ids = DescriptorDatabaseFile(
            path, self.retriever.n_bins).read_arrays(self.retriever.capacity)
        n = len(codes)
        if n < total:
            logger.warning("store holds %d records; loading the first %d "
                           "(capacity)", total, n)
            self._capacity_warned = True
        for lo in range(0, n, _LOAD_CHUNK):
            hi = min(lo + _LOAD_CHUNK, n)
            hist = dequantize_numpy(codes[lo:hi])
            kfs = [Keyframe(keyframe_id=int(ids[i]), scan_id=int(ids[i]),
                            points=None,
                            pose=pose_from_7dof(p7[i].astype(np.float64)),
                            timestamp=float(ts[i]),
                            descriptor=hist[i - lo])
                   for i in range(lo, hi)]
            self.keyframes.extend(kfs)
            self.retriever.add_to_database(
                np.stack([self._stage1_vector(kf) for kf in kfs]),
                np.stack([kf.pose[:3, 3] for kf in kfs]))
        return n


def create_two_stage_retrieval(top_k: int = 10,
                               spatial_filter_distance: float = 50.0,
                               n_bins: int = 800, capacity: int = 100_000,
                               device: DeviceLike = "cuda"
                               ) -> TwoStageRetrieval:
    return TwoStageRetrieval(top_k=top_k,
                             spatial_filter_distance=spatial_filter_distance,
                             n_bins=n_bins, capacity=capacity, device=device)


def batch_loop_closing(query_keyframes: List[Keyframe],
                       database_keyframes: List[Keyframe],
                       top_k: int = 10,
                       spatial_filter_distance: float = 50.0,
                       verify: bool = True, device: DeviceLike = "cuda"
                       ) -> Dict[int, List[Dict]]:
    """Offline loop closing of many queries: stage 1 as one batched query
    over all of them, stage 2 per query on the host."""
    n_bins = database_keyframes[0].descriptor.shape[-1]
    retrieval = create_two_stage_retrieval(
        top_k=top_k, spatial_filter_distance=spatial_filter_distance,
        n_bins=n_bins, capacity=max(len(database_keyframes), 1),
        device=device)
    for kf in database_keyframes:
        retrieval.add_keyframe(kf)
    q_hists = np.stack([q.descriptor for q in query_keyframes])
    q_pos = np.stack([q.pose[:3, 3] if q.pose is not None else np.zeros(3)
                      for q in query_keyframes])
    idx, dist = retrieval.retriever.query_batch(
        q_hists, top_k=top_k, query_positions=q_pos,
        spatial_min_distance=spatial_filter_distance)
    results: Dict[int, List[Dict]] = {}
    for i, q in enumerate(query_keyframes):
        cands = [LoopClosureCandidate(int(j), float(d))
                 for j, d in zip(idx[i], dist[i]) if np.isfinite(d)]
        if not verify:
            results[i] = [{"database_idx": c.database_idx,
                           "wasserstein_distance": c.distance}
                          for c in cands]
            continue
        results[i] = [retrieval._edge(q, c) for c in
                      retrieval._geometric_verification(q.points, cands)]
    return results
