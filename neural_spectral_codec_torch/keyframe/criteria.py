"""Keyframe selection criteria, host-side numpy. Copied from
``neural_spectral_codec_tpu/keyframe/criteria.py:24-160`` (with
``estimate_keyframe_rate`` and ``analyze_keyframe_spacing``).

OR logic over {distance > 0.5 m, rotation > 15°, Δt > 5 s}; the voxel-IoU
novelty check (novel when overlap < 0.7) runs only when the three cheap
criteria all fail.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from neural_spectral_codec_torch.data.pose_utils import (
    compute_overlap, euclidean_distance, relative_pose,
    rotation_angle_degrees)


class KeyframeSelectionCriteria:
    def __init__(self, distance_threshold: float = 0.5,
                 rotation_threshold: float = 15.0,
                 overlap_threshold: float = 0.7,
                 temporal_threshold: float = 5.0, voxel_size: float = 0.2,
                 rng: Optional[np.random.Generator] = None):
        self.distance_threshold = distance_threshold
        self.rotation_threshold = rotation_threshold
        self.overlap_threshold = overlap_threshold
        self.temporal_threshold = temporal_threshold
        self.voxel_size = voxel_size
        self._rng = rng or np.random.default_rng(0)

    def check_distance(self, pose_current, pose_last) -> Tuple[bool, float]:
        d = euclidean_distance(pose_current, pose_last)
        return d > self.distance_threshold, d

    def check_rotation(self, pose_current, pose_last) -> Tuple[bool, float]:
        r = rotation_angle_degrees(pose_current, pose_last)
        return r > self.rotation_threshold, r

    def check_temporal(self, ts_current, ts_last) -> Tuple[bool, float]:
        dt = abs(ts_current - ts_last)
        return dt > self.temporal_threshold, dt

    def check_geometric_novelty(self, points_current, points_last,
                                pose_current, pose_last
                                ) -> Tuple[bool, float]:
        T_rel = relative_pose(pose_last, pose_current)
        overlap = compute_overlap(points_last[:, :3], points_current[:, :3],
                                  T_rel, voxel_size=self.voxel_size,
                                  rng=self._rng)
        return overlap < self.overlap_threshold, overlap

    def should_select_keyframe(self, pose_current: np.ndarray,
                               timestamp_current: float,
                               points_current: Optional[np.ndarray],
                               pose_last: np.ndarray, timestamp_last: float,
                               points_last: Optional[np.ndarray],
                               require_all: bool = False
                               ) -> Tuple[bool, dict]:
        """OR logic with early termination (``require_all``: AND)."""
        dist_ok, dist_v = self.check_distance(pose_current, pose_last)
        rot_ok, rot_v = self.check_rotation(pose_current, pose_last)
        temp_ok, temp_v = self.check_temporal(timestamp_current,
                                              timestamp_last)
        details = {
            "distance": {"satisfied": dist_ok, "value": dist_v,
                         "threshold": self.distance_threshold},
            "rotation": {"satisfied": rot_ok, "value": rot_v,
                         "threshold": self.rotation_threshold},
            "temporal": {"satisfied": temp_ok, "value": temp_v,
                         "threshold": self.temporal_threshold},
        }
        if not require_all and (dist_ok or rot_ok or temp_ok):
            details["geometric"] = {"satisfied": None, "value": None,
                                    "threshold": self.overlap_threshold,
                                    "note": "Skipped (early termination)"}
            details["selected"] = True
            return True, details

        if points_current is not None and points_last is not None:
            geom_ok, overlap = self.check_geometric_novelty(
                points_current, points_last, pose_current, pose_last)
            details["geometric"] = {"satisfied": geom_ok, "value": overlap,
                                    "threshold": self.overlap_threshold}
        else:
            geom_ok = False
            details["geometric"] = {"satisfied": None, "value": None,
                                    "threshold": self.overlap_threshold,
                                    "note": "Point clouds not provided"}

        if require_all:
            checks = [dist_ok, rot_ok, temp_ok]
            if points_current is not None and points_last is not None:
                checks.append(geom_ok)
            selected = all(checks)
        else:
            selected = geom_ok          # the cheap criteria are all false
        details["selected"] = selected
        return selected, details


def estimate_keyframe_rate(distance_threshold: float = 0.5,
                           rotation_threshold: float = 15.0,
                           avg_velocity: float = 5.0,
                           avg_angular_velocity: float = 10.0) -> float:
    """Expected keyframe rate in Hz under OR logic: one keyframe per the
    shorter of the distance and rotation periods."""
    t_d = (distance_threshold / avg_velocity if avg_velocity > 0
           else float("inf"))
    t_r = (rotation_threshold / avg_angular_velocity
           if avg_angular_velocity > 0 else float("inf"))
    t = min(t_d, t_r)
    return 1.0 / t if t > 0 else 0.0


def analyze_keyframe_spacing(poses: np.ndarray, timestamps: np.ndarray,
                             selected_indices: np.ndarray) -> dict:
    """Distance and time statistics between consecutive selected frames."""
    if len(selected_indices) < 2:
        return {"num_keyframes": len(selected_indices),
                "mean_distance": 0.0, "mean_time": 0.0}
    sel = np.asarray(selected_indices)
    pos = poses[sel][:, :3, 3]
    dists = np.linalg.norm(np.diff(pos, axis=0), axis=1)
    dts = np.diff(timestamps[sel])
    mean_dt = float(np.mean(dts))
    return {
        "num_keyframes": len(sel),
        "mean_distance": float(np.mean(dists)),
        "std_distance": float(np.std(dists)),
        "min_distance": float(np.min(dists)),
        "max_distance": float(np.max(dists)),
        "mean_time": mean_dt,
        "std_time": float(np.std(dts)),
        "min_time": float(np.min(dts)),
        "max_time": float(np.max(dts)),
        "avg_keyframe_rate": 1.0 / mean_dt if mean_dt > 0 else 0.0,
    }
