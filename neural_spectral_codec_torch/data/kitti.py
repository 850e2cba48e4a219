"""KITTI odometry reader, the port's copy of
``neural_spectral_codec_tpu/data/kitti.py``: ``.bin`` float32 [x, y, z, i]
scans, 12-value ``poses.txt`` rows → SE(3), synthesized 10 Hz
timestamps."""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np


class KITTILoader:
    """Expected layout: ``data_root/sequences/<seq>/velodyne/*.bin`` plus
    ``poses.txt``. Items: {'points' (N,4), 'pose' (4,4), 'timestamp', 'idx'}."""

    def __init__(self, data_root: str, sequence: str, lazy_load: bool = True):
        self.data_root = Path(data_root)
        self.sequence = sequence
        self.lazy_load = lazy_load
        self.sequence_path = self.data_root / "sequences" / sequence
        self.velodyne_path = self.sequence_path / "velodyne"
        self.poses_file = self.sequence_path / "poses.txt"

        if not self.sequence_path.exists():
            raise FileNotFoundError(f"Sequence path not found: {self.sequence_path}")
        if not self.velodyne_path.exists():
            raise FileNotFoundError(f"Velodyne path not found: {self.velodyne_path}")

        self.frame_files = sorted(self.velodyne_path.glob("*.bin"))
        self.num_frames = len(self.frame_files)
        if self.num_frames == 0:
            raise ValueError(f"No .bin files found in {self.velodyne_path}")

        self.poses = self._load_poses()
        # KITTI velodyne is 10 Hz; timestamps synthesized
        self.timestamps = np.arange(self.num_frames) * 0.1
        self.point_clouds = (
            [self._load_point_cloud(i) for i in range(self.num_frames)]
            if not lazy_load else None
        )

    def _load_poses(self) -> Optional[np.ndarray]:
        if not self.poses_file.exists():
            return None
        rows = []
        with open(self.poses_file) as f:
            for line in f:
                vals = line.split()
                if len(vals) != 12:
                    continue
                rows.append([float(v) for v in vals])
        if not rows:
            return None
        mats = np.asarray(rows, dtype=np.float64).reshape(-1, 3, 4)
        poses = np.tile(np.eye(4), (len(mats), 1, 1))
        poses[:, :3, :] = mats
        return poses

    def _load_point_cloud(self, idx: int) -> np.ndarray:
        return np.fromfile(self.frame_files[idx], dtype=np.float32).reshape(-1, 4)

    def __len__(self) -> int:
        return self.num_frames

    def __getitem__(self, idx: int) -> dict:
        if idx < 0 or idx >= self.num_frames:
            raise IndexError(f"Index {idx} out of range [0, {self.num_frames})")
        points = (
            self._load_point_cloud(idx) if self.lazy_load else self.point_clouds[idx]
        )
        return self._assemble(idx, points)

    def _assemble(self, idx: int, points: np.ndarray) -> dict:
        """Item dict for already-decoded points (shared with the native
        prefetch path, data/native_io.py)."""
        out = {"points": points, "timestamp": self.timestamps[idx], "idx": idx}
        if self.poses is not None:
            out["pose"] = self.poses[idx]
        return out

    # convenience API
    def get_point_cloud(self, idx: int) -> np.ndarray:
        return self[idx]["points"]

    def get_pose(self, idx: int) -> Optional[np.ndarray]:
        return None if self.poses is None else self.poses[idx]

    def get_relative_pose(self, idx1: int, idx2: int) -> Optional[np.ndarray]:
        if self.poses is None:
            return None
        return np.linalg.inv(self.poses[idx1]) @ self.poses[idx2]

    def get_distance(self, idx1: int, idx2: int) -> Optional[float]:
        if self.poses is None:
            return None
        return float(np.linalg.norm(self.poses[idx2][:3, 3] - self.poses[idx1][:3, 3]))

    def get_frames_in_range(self, query_idx: int, min_distance: float,
                            max_distance: float) -> List[int]:
        if self.poses is None:
            return []
        d = np.linalg.norm(
            self.poses[:, :3, 3] - self.poses[query_idx][:3, 3], axis=1
        )
        ok = (d >= min_distance) & (d <= max_distance)
        ok[query_idx] = False
        return np.where(ok)[0].tolist()


def load_kitti_sequence(data_root: str, sequence: str, lazy_load: bool = True) -> KITTILoader:
    return KITTILoader(data_root, sequence, lazy_load)
