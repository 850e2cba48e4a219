"""Incremental keyframe selector, host-side. Copied from
``neural_spectral_codec_tpu/keyframe/selector.py:21-218``: the first scan
is forced, then the OR-logic criteria decide; the keyframe list is a
FIFO capped at ``max_keyframes``. ``select_keyframes_from_kitti`` runs a
selector over a whole loader.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from neural_spectral_codec_torch.keyframe.criteria import (
    KeyframeSelectionCriteria)

logger = logging.getLogger(__name__)


@dataclass
class Keyframe:
    keyframe_id: int
    scan_id: int
    points: np.ndarray          # (N, 3|4)
    pose: np.ndarray            # (4, 4)
    timestamp: float
    descriptor: Optional[np.ndarray] = None   # spectral histogram
    embedding: Optional[np.ndarray] = None    # GNN embedding
    sequence_id: int = 0        # for per-sequence mining


class KeyframeSelector:
    def __init__(self, distance_threshold: float = 0.5,
                 rotation_threshold: float = 15.0,
                 overlap_threshold: float = 0.7,
                 temporal_threshold: float = 5.0, voxel_size: float = 0.2,
                 max_keyframes: int = 10000):
        self.criteria = KeyframeSelectionCriteria(
            distance_threshold=distance_threshold,
            rotation_threshold=rotation_threshold,
            overlap_threshold=overlap_threshold,
            temporal_threshold=temporal_threshold, voxel_size=voxel_size)
        self.max_keyframes = max_keyframes
        self.keyframes: List[Keyframe] = []
        self.keyframe_id_counter = 0
        self.last_keyframe: Optional[Keyframe] = None
        self.total_scans_processed = 0
        self.selection_details_history: List[dict] = []

    def process_scan(self, scan_id: int, points: np.ndarray, pose: np.ndarray,
                     timestamp: float, force_first: bool = True,
                     sequence_id: int = 0
                     ) -> Tuple[bool, Optional[Keyframe], dict]:
        self.total_scans_processed += 1
        if self.last_keyframe is None:
            if not force_first:
                return False, None, {"selected": False,
                                     "reason": "Not forcing first"}
            kf = self._create(scan_id, points, pose, timestamp, sequence_id)
            details = {"selected": True, "reason": "First keyframe",
                       "keyframe_id": kf.keyframe_id}
            self.selection_details_history.append(details)
            return True, kf, details

        selected, details = self.criteria.should_select_keyframe(
            pose_current=pose, timestamp_current=timestamp,
            points_current=points, pose_last=self.last_keyframe.pose,
            timestamp_last=self.last_keyframe.timestamp,
            points_last=self.last_keyframe.points, require_all=False)
        if selected:
            kf = self._create(scan_id, points, pose, timestamp, sequence_id)
            if len(self.keyframes) > self.max_keyframes:
                self.keyframes.pop(0)                  # FIFO cap
            details["keyframe_id"] = kf.keyframe_id
            self.selection_details_history.append(details)
            return True, kf, details
        self.selection_details_history.append(details)
        return False, None, details

    def _create(self, scan_id, points, pose, timestamp,
                sequence_id) -> Keyframe:
        kf = Keyframe(keyframe_id=self.keyframe_id_counter, scan_id=scan_id,
                      points=points, pose=pose, timestamp=timestamp,
                      sequence_id=sequence_id)
        self.keyframe_id_counter += 1
        self.last_keyframe = kf
        self.keyframes.append(kf)
        return kf

    def get_statistics(self) -> dict:
        """Compression ratio, keyframe rate, per-criterion counts."""
        if not self.keyframes:
            return {"num_keyframes": 0, "num_scans": self.total_scans_processed,
                    "compression_ratio": 0.0}
        compression = self.total_scans_processed / len(self.keyframes)
        if len(self.keyframes) > 1:
            dur = self.keyframes[-1].timestamp - self.keyframes[0].timestamp
            rate = (len(self.keyframes) - 1) / dur if dur > 0 else 0.0
        else:
            rate = 0.0
        counts = {"distance": 0, "rotation": 0, "temporal": 0, "geometric": 0}
        for d in self.selection_details_history:
            if d.get("selected", False):
                for k in counts:
                    entry = d.get(k)
                    if isinstance(entry, dict) and entry.get("satisfied"):
                        counts[k] += 1
        return {"num_keyframes": len(self.keyframes),
                "num_scans": self.total_scans_processed,
                "compression_ratio": compression,
                "avg_keyframe_rate_hz": rate, "criteria_counts": counts}


def select_keyframes_from_kitti(
    kitti_loader,
    distance_threshold: float = 0.5,
    rotation_threshold: float = 15.0,
    overlap_threshold: float = 0.7,
    temporal_threshold: float = 5.0,
) -> List[Keyframe]:
    """Keyframes of a whole loader (any loader of frame dicts with
    ``points``, ``pose`` and ``timestamp``, not only KITTI); logs the
    selector's statistics."""
    selector = KeyframeSelector(
        distance_threshold=distance_threshold,
        rotation_threshold=rotation_threshold,
        overlap_threshold=overlap_threshold,
        temporal_threshold=temporal_threshold,
    )
    for scan_id in range(len(kitti_loader)):
        frame = kitti_loader[scan_id]
        selector.process_scan(scan_id, frame["points"], frame["pose"],
                              frame["timestamp"])
    stats = selector.get_statistics()
    logger.info("Selected %d keyframes from %d scans",
                stats["num_keyframes"], stats["num_scans"])
    logger.info("Compression ratio: %.1fx", stats["compression_ratio"])
    if "avg_keyframe_rate_hz" in stats:
        logger.info("Avg keyframe rate: %.2f Hz",
                    stats["avg_keyframe_rate_hz"])
    return selector.keyframes
