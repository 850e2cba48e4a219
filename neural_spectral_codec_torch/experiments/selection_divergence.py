"""How often the frame-corrected overlap changes keyframe selection: the
port of ``experiments/selection_divergence.py``.

    python -m neural_spectral_codec_torch.experiments.selection_divergence \\
        [--frames 300] [--points 16384] [--json out.json]

The reference's ``compute_overlap`` moves the wrong cloud (its
pose_utils.py:353), which offsets the two clouds by about twice the
motion and deflates the IoU; the port, like the JAX package, aligns the
frames. On a slow straight creep through a cylinder world (0.25 m a
frame, no rotation, 10 Hz, so only the IoU criterion can select) two
selectors run on the same stream: ``ours`` (the port's criteria) and
``ours+refconv`` (the IoU evaluated with the reference's convention, by
swapping the clouds). Also reported: the IoU under both conventions at
fixed offsets, the selected ids and their Jaccard index. The JAX
script's third column, the reference's own selector, needs the
reference's sources, which the repository does not hold; it is left
out, as the JAX script leaves it out when they are missing. Everything
here is host numpy, as in the JAX script: there is no device argument.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from neural_spectral_codec_torch.data.pose_utils import (
    compute_overlap, relative_pose)
from neural_spectral_codec_torch.data.synthetic import SyntheticWorld
from neural_spectral_codec_torch.keyframe.criteria import (
    KeyframeSelectionCriteria)
from neural_spectral_codec_torch.keyframe.selector import KeyframeSelector

# voxel 2.0 m puts the same-place IoU (~0.82) above the 0.7 threshold;
# every other criterion is out of reach
THRESHOLDS = dict(distance_threshold=1e6, rotation_threshold=361.0,
                  overlap_threshold=0.7, temporal_threshold=1e9,
                  voxel_size=2.0)
OFFSETS = (0.0, 0.5, 1.0, 2.0, 4.0, 8.0)


class RefConventionCriteria(KeyframeSelectionCriteria):
    """The port's criteria with the IoU evaluated the reference's way:
    IoU(voxels(T_rel · last), voxels(current)), by swapping the clouds."""

    def check_geometric_novelty(self, points_current, points_last,
                                pose_current, pose_last):
        T_rel = relative_pose(pose_last, pose_current)
        overlap = compute_overlap(points_current[:, :3], points_last[:, :3],
                                  T_rel, voxel_size=self.voxel_size,
                                  rng=self._rng)
        return overlap < self.overlap_threshold, overlap


def make_stream(n_frames: int = 300, step: float = 0.25,
                n_points: int = 16384, seed: int = 3) -> List[tuple]:
    """(scan id, points, pose, timestamp) of a straight creep of ``step``
    metres a frame at 10 Hz (copied from the JAX script)."""
    world = SyntheticWorld(seed=seed)
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_frames):
        pose = np.eye(4, dtype=np.float64)
        pose[0, 3] = i * step
        pts = world.scan(pose, n_points=n_points, rng=rng)
        frames.append((i, pts, pose, i * 0.1))
    return frames


def run_selector(frames, selector) -> List[int]:
    for scan_id, pts, pose, ts in frames:
        selector.process_scan(scan_id, pts, pose, ts)
    return [kf.scan_id for kf in selector.keyframes]


def iou_vs_motion(n_points: int = 16384) -> Dict[float, Dict[str, float]]:
    """IoU at 2 m voxels between a scan and one ``offset`` metres ahead,
    under the corrected and the reference convention."""
    world = SyntheticWorld(seed=3)
    rng = np.random.default_rng(0)
    p0 = np.eye(4)
    pts0 = world.scan(p0, n_points=n_points, rng=rng)
    out = {}
    for off in OFFSETS:
        p1 = np.eye(4)
        p1[0, 3] = off
        pts1 = world.scan(p1, n_points=n_points, rng=rng)
        T = relative_pose(p0, p1)
        out[off] = {
            "ours": compute_overlap(pts0[:, :3], pts1[:, :3], T,
                                    voxel_size=2.0,
                                    rng=np.random.default_rng(1)),
            "reference_convention": compute_overlap(
                pts1[:, :3], pts0[:, :3], T, voxel_size=2.0,
                rng=np.random.default_rng(1))}
    return out


def jaccard(a, b) -> float:
    a, b = set(a), set(b)
    return len(a & b) / max(len(a | b), 1)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--points", type=int, default=16384)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    iou = iou_vs_motion(args.points)
    print("IoU vs motion (voxel 2.0 m):")
    print("  offset   ours(corrected)   reference-convention")
    for off, r in iou.items():
        print(f"  {off:5.1f} m      {r['ours']:.4f}            "
              f"{r['reference_convention']:.4f}")

    frames = make_stream(n_frames=args.frames, n_points=args.points)
    results = {"ours": run_selector(frames, KeyframeSelector(**THRESHOLDS))}
    sel_rc = KeyframeSelector(**THRESHOLDS)
    sel_rc.criteria = RefConventionCriteria(**THRESHOLDS)
    results["ours+refconv"] = run_selector(frames, sel_rc)
    n = len(frames)
    print(f"\nSelection on {n}-frame slow-creep stream (step 0.25 m, "
          f"overlap_threshold={THRESHOLDS['overlap_threshold']}, all other "
          "criteria unreachable):")
    for name, ids in results.items():
        print(f"  {name:14s}: {len(ids):3d} keyframes "
              f"(rate {len(ids) / n:.3f})  first 10: {ids[:10]}")
    agree = jaccard(results["ours"], results["ours+refconv"])
    print(f"  ours vs ours+refconv, Jaccard over selected ids: {agree:.3f}")
    out = {"iou_vs_motion": {str(k): v for k, v in iou.items()},
           "frames": n, "selected": results, "jaccard": agree}
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
