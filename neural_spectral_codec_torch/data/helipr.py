"""HeLiPR (Velodyne VLP-16) reader, the port's copy of
``neural_spectral_codec_tpu/data/helipr.py``:

  * 22-byte records: x, y, z, intensity float32 + ring uint16 + time
    float32; the ring ids ride along as ``ring_ids``
  * ground truth ``LiDAR_GT/Velodyne_gt.txt`` rows:
    [ns-timestamp, x, y, z, qx, qy, qz, qw]
  * scans associated to ground truth by binary search with a 100 ms
    tolerance; scans with no ground truth within it are dropped
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from neural_spectral_codec_torch.data.pose_utils import quat_wxyz_to_matrix

_HELIPR_DTYPE = np.dtype([
    ("x", np.float32), ("y", np.float32), ("z", np.float32),
    ("intensity", np.float32), ("ring", np.uint16), ("time", np.float32),
])

_GT_TOLERANCE_NS = 100_000_000  # 100 ms


class HeLiPRLoader:
    """Layout: ``root/LiDAR/Velodyne/<ns>.bin`` + ``root/LiDAR_GT/Velodyne_gt.txt``."""

    def __init__(self, root: str, lazy_load: bool = True):
        self.root = Path(root)
        self.lazy_load = lazy_load
        self.velodyne_dir = self.root / "LiDAR" / "Velodyne"
        self.gt_file = self.root / "LiDAR_GT" / "Velodyne_gt.txt"

        if not self.velodyne_dir.exists():
            raise ValueError(f"Velodyne directory not found: {self.velodyne_dir}")
        if not self.gt_file.exists():
            raise ValueError(f"Ground truth file not found: {self.gt_file}")

        self._load_ground_truth()
        self._associate_scans()
        self.point_clouds = self.ring_ids = None
        if not lazy_load:
            loaded = [self._load_velodyne_full(f) for f in self.scan_files]
            self.point_clouds = [p for p, _ in loaded]
            self.ring_ids = [r for _, r in loaded]

    def _load_ground_truth(self):
        ts, poses = [], []
        with open(self.gt_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 8:
                    continue
                t = int(parts[0])
                x, y, z = (float(p) for p in parts[1:4])
                qx, qy, qz, qw = (float(p) for p in parts[4:8])
                T = np.eye(4)
                T[:3, :3] = quat_wxyz_to_matrix(np.array([qw, qx, qy, qz]))
                T[:3, 3] = [x, y, z]
                ts.append(t)
                poses.append(T)
        self.timestamps_gt = np.asarray(ts, dtype=np.int64)
        self.poses = np.asarray(poses)

    def _associate_scans(self):
        files = sorted(self.velodyne_dir.glob("*.bin"))
        self.scan_files, self.scan_timestamps = [], []
        scan_poses, self.scan_pose_indices = [], []
        for f in files:
            t = int(f.stem)
            idx = int(np.clip(np.searchsorted(self.timestamps_gt, t),
                              0, len(self.timestamps_gt) - 1))
            diff = abs(t - int(self.timestamps_gt[idx]))
            if idx > 0:
                prev = abs(t - int(self.timestamps_gt[idx - 1]))
                if prev < diff:
                    idx, diff = idx - 1, prev
            if diff <= _GT_TOLERANCE_NS:
                self.scan_files.append(f)
                self.scan_timestamps.append(t)
                scan_poses.append(self.poses[idx])
                self.scan_pose_indices.append(idx)
        self.scan_poses = np.asarray(scan_poses)

    @staticmethod
    def _load_velodyne_full(filepath: Path):
        """(points (N, 4) float32, ring ids (N,) int64). The explicit
        ring field feeds the ring fast path — VLP-16 streams are
        firing-interleaved, so ring inference from elevation order
        (ops/ring_path.infer_ring_ids_from_sweep) cannot recover them."""
        data = np.fromfile(filepath, dtype=_HELIPR_DTYPE)
        pts = np.stack(
            [data["x"], data["y"], data["z"], data["intensity"]], axis=-1
        ).astype(np.float32)
        return pts, data["ring"].astype(np.int64)

    def __len__(self) -> int:
        return len(self.scan_files)

    def __getitem__(self, idx: int) -> dict:
        if idx < 0 or idx >= len(self):
            raise IndexError(f"Index {idx} out of range [0, {len(self)})")
        if self.lazy_load:
            points, rings = self._load_velodyne_full(self.scan_files[idx])
        else:
            points, rings = self.point_clouds[idx], self.ring_ids[idx]
        return self._assemble(idx, points, rings)

    def _assemble(self, idx: int, points: np.ndarray,
                  ring_ids=None) -> dict:
        """Item dict for already-decoded points (shared with the native
        prefetch path, data/native_io.py)."""
        return {
            "points": points,
            "ring_ids": ring_ids,
            "pose": self.scan_poses[idx],
            "timestamp": self.scan_timestamps[idx] / 1e9,
            "idx": idx,
        }

    def get_all_poses(self) -> np.ndarray:
        return self.scan_poses
