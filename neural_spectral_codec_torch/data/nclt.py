"""NCLT (Michigan Campus, HDL-32E) reader, the port's copy of
``neural_spectral_codec_tpu/data/nclt.py``:

  * 12-byte packed records: x, y, z uint16 (meters = raw·0.005 − 100),
    intensity uint8 (/255), padding uint8, extra uint32
  * filenames are µs timestamps; ground-truth CSV rows
    [timestamp, x, y, z, roll, pitch, yaw] matched by nearest timestamp
    via searchsorted; ZYX Euler → SE(3)
  * point filter: finite and |coord| < 200 m

No pandas: the CSV is parsed with ``np.genfromtxt`` (invalid rows
dropped). A ground truth that cannot be read gives ``poses = None`` and a
scan that cannot be read an empty cloud, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

_NCLT_DTYPE = np.dtype([
    ("x", "<u2"), ("y", "<u2"), ("z", "<u2"),
    ("intensity", "u1"), ("padding", "u1"), ("extra", "<u4"),
])


def euler_zyx_to_se3(x, y, z, roll, pitch, yaw) -> np.ndarray:
    """ZYX-order Euler → SE(3) (JAX nclt.py:27)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = [x, y, z]
    return T


class NCLTLoader:
    """Layout: ``data_root/<date>/velodyne_sync/<µs>.bin`` +
    ``data_root/<date>/groundtruth_<date>.csv``."""

    def __init__(self, data_root: str, date: str, lazy_load: bool = True):
        self.data_root = Path(data_root)
        self.date = date
        self.lazy_load = lazy_load
        self.sequence_path = self.data_root / date
        self.velodyne_path = self.sequence_path / "velodyne_sync"
        self.gt_file = self.sequence_path / f"groundtruth_{date}.csv"

        if not self.sequence_path.exists():
            raise FileNotFoundError(f"Sequence path not found: {self.sequence_path}")
        if not self.velodyne_path.exists():
            raise FileNotFoundError(f"Velodyne path not found: {self.velodyne_path}")

        self.frame_files = sorted(self.velodyne_path.glob("*.bin"))
        self.num_frames = len(self.frame_files)
        if self.num_frames == 0:
            raise ValueError(f"No .bin files found in {self.velodyne_path}")

        ts_us = np.array([int(f.stem) for f in self.frame_files], dtype=np.int64)
        self._vel_timestamps_us = ts_us
        self.timestamps = (ts_us - ts_us[0]) / 1e6  # seconds, zero-based

        self.poses = self._load_poses()
        self.point_clouds = (
            [self._load_point_cloud(i) for i in range(self.num_frames)]
            if not lazy_load else None
        )

    def _load_poses(self) -> Optional[np.ndarray]:
        if not self.gt_file.exists():
            return None
        try:
            gt = np.genfromtxt(self.gt_file, delimiter=",", dtype=np.float64)
            if gt.ndim != 2 or gt.shape[1] < 7:
                return None
            gt = gt[np.isfinite(gt[:, :7]).all(axis=1)]
            ts_gt = gt[:, 0].astype(np.int64)
            order = np.argsort(ts_gt)
            ts_gt, gt = ts_gt[order], gt[order]

            # nearest-timestamp association via searchsorted
            ins = np.clip(np.searchsorted(ts_gt, self._vel_timestamps_us),
                          1, len(ts_gt) - 1)
            left, right = ins - 1, ins
            pick = np.where(
                np.abs(self._vel_timestamps_us - ts_gt[left])
                <= np.abs(self._vel_timestamps_us - ts_gt[right]),
                left, right,
            )
            rows = gt[pick]
            return np.stack([
                euler_zyx_to_se3(r[1], r[2], r[3], r[4], r[5], r[6]) for r in rows
            ])
        except Exception:
            return None

    def _load_point_cloud(self, idx: int) -> np.ndarray:
        try:
            raw = np.fromfile(self.frame_files[idx], dtype=_NCLT_DTYPE)
        except Exception:
            return np.zeros((0, 4), dtype=np.float32)
        if len(raw) == 0:
            return np.zeros((0, 4), dtype=np.float32)
        pts = np.column_stack([
            raw["x"].astype(np.float32) * 0.005 - 100.0,
            raw["y"].astype(np.float32) * 0.005 - 100.0,
            raw["z"].astype(np.float32) * 0.005 - 100.0,
            raw["intensity"].astype(np.float32) / 255.0,
        ])
        ok = (
            np.isfinite(pts[:, :3]).all(axis=1)
            & (np.abs(pts[:, :3]) < 200.0).all(axis=1)
        )
        return pts[ok]

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
        pose = (
            self.poses[idx]
            if self.poses is not None and idx < len(self.poses)
            else np.eye(4)
        )
        return {
            "points": points,
            "pose": pose,
            "timestamp": self.timestamps[idx],
            "idx": idx,
            "dataset": "nclt",
            "date": self.date,
        }

    def get_sequence_info(self) -> dict:
        return {
            "dataset": "nclt",
            "date": self.date,
            "num_frames": self.num_frames,
            "duration": float(self.timestamps[-1]) if self.num_frames else 0.0,
            "has_poses": self.poses is not None,
            "sensor": "Velodyne HDL-32E",
            "rings": 32,
        }
