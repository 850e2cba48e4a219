"""The HeLiPR (VLP-16) → KITTI (HDL-64E) recipe of
configs/training_helipr_to_kitti.yaml end to end on synthetic streams:
the port of ``experiments/cross_sensor_uplift.py``.

    python -m neural_spectral_codec_torch.experiments.cross_sensor_uplift \\
        [--epochs 25] [--frames 300] [--seed-base 0] \\
        [--checkpoint-dir DIR] [--device cuda] [--json out.json]

The training stream is a simulated 16-beam sensor over ±15° (seed
``--seed-base``), the validation stream a 64-beam sensor over −24.8..2°
(seed + 1), both with a 200° azimuth wedge and 30% dropout a scan, 16,384
points, two and a half laps, encoded with the recipe's 16 fat rows and
circular interpolation (the recipe's ring-major encoder: the ring kernel
where a scan's rings are found, the general path otherwise). Reported:
(1) the raw descriptors' Recall@{1,5} on the 64-beam stream, (2) the
GNN's best validation Recall@1 after training on the 16-beam stream
only, (3) mixed-sensor retrieval top-1 over 30 places of one loop on
clean scans: 64-beam queries against a 16-beam database over the
same field of view, and VLP-16 against HDL-64E fields of view with the
overlap band clipped or dropped.
"""

from __future__ import annotations

import argparse
import json
import logging
import tempfile
from pathlib import Path
from typing import Dict

import numpy as np

from neural_spectral_codec_torch.experiments.degraded_recall import (
    REPO, raw_recall, train_best_r1)

HDL = (-24.8, 2.0)
VLP = (-15.0, 15.0)


def mixed_sensor_top1(device) -> Dict[str, float]:
    """Top-1 of W₁ retrieval over 30 places with queries and database
    from different simulated sensors of the same 30,000-point scans (JAX
    script, part 3): beam density (16-beam database, 64-beam queries, HDL field of
    view), native field of view with the overlap band clipped, and with
    it dropped over 8 rows."""
    from neural_spectral_codec_torch.data.synthetic import (
        SyntheticWorld, loop_trajectory, snap_to_beams)
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_clouds)
    from neural_spectral_codec_torch.ops.wasserstein import (
        wasserstein_matrix)
    world = SyntheticWorld(seed=7)
    poses = loop_trajectory(30, radius=100.0, loops=1.0)
    rng = np.random.default_rng(0)

    def top1(cfg, db_beams, db_fov, q_beams, q_fov):
        db, q = [], []
        for pose in poses:
            dense = world.scan(pose, n_points=30000, rng=rng)
            db.append(snap_to_beams(dense, db_beams, db_fov))
            q.append(snap_to_beams(dense, q_beams, q_fov))
        d = wasserstein_matrix(encode_clouds(q, 32768, cfg, device=device),
                               encode_clouds(db, 32768, cfg, device=device))
        hits = d.argmin(dim=1).cpu().numpy() == np.arange(len(poses))
        return float(hits.mean())

    return {
        "beam_density": top1(SpectralEncoderConfig(
            n_elevation=16, target_elevation_bins=16), 16, HDL, 64, HDL),
        "native_fov_clip": top1(SpectralEncoderConfig(
            n_elevation=16, target_elevation_bins=16,
            elevation_range_deg=(-15.0, 2.0)), 16, VLP, 64, HDL),
        "native_fov_drop": top1(SpectralEncoderConfig(
            n_elevation=8, target_elevation_bins=8,
            elevation_range_deg=(-15.0, 2.0), elevation_mode="drop"),
            16, VLP, 64, HDL),
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--seed-base", type=int, default=0,
                   help="the training stream's seed; validation uses "
                        "seed-base + 1")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from neural_spectral_codec_torch.data.synthetic import SensorSimLoader
    from neural_spectral_codec_torch.device import resolve_device
    from neural_spectral_codec_torch.utils.config import load_config

    device = resolve_device(args.device)
    cfg = load_config(str(REPO / "configs" /
                          "training_helipr_to_kitti.yaml"))
    cfg["encoding"]["max_points"] = 16384
    cfg["keyframe"]["distance_threshold"] = 3.0
    cfg["training"].update({"n_epochs": args.epochs,
                            "patience": args.epochs,
                            "normalize_embeddings": True})
    train = SensorSimLoader(n_frames=args.frames, seed=args.seed_base,
                            n_points=16384, loops=2.5, n_beams=16,
                            beam_fov_deg=VLP, wedge_deg=200.0, dropout=0.3)
    val = SensorSimLoader(n_frames=3 * args.frames // 4,
                          seed=args.seed_base + 1, n_points=16384,
                          loops=2.5, n_beams=64, beam_fov_deg=HDL,
                          wedge_deg=200.0, dropout=0.3)

    with tempfile.TemporaryDirectory(prefix="nsc_cross_") as tmp:
        cfg["system"]["checkpoint_dir"] = args.checkpoint_dir or tmp
        raw = raw_recall(cfg, val, device, (1, 5))
        r = raw["recall"]
        print(f"raw descriptors (64-beam val) : R@1 {r[1]:.3f}  "
              f"R@5 {r[5]:.3f}  ({raw['n_queries']} queries)")
        gnn_r1 = train_best_r1(cfg, train, val, args.epochs, device)
    rel = (gnn_r1 - r[1]) / max(r[1], 1e-9) * 100
    print(f"GNN-enhanced    (64-beam val) : R@1 {gnn_r1:.3f} "
          f"({rel:+.0f}% relative vs raw {r[1]:.3f})")
    top1 = mixed_sensor_top1(device)
    print(f"beam-density retrieval 64q -> 16-db (same FOV) : top-1 "
          f"{top1['beam_density']:.3f} (30 places)")
    print(f"native-FOV retrieval VLP-db <- HDL-q (overlap-FOV encoding, "
          f"clip): top-1 {top1['native_fov_clip']:.3f}")
    print(f"native-FOV retrieval VLP-db <- HDL-q (elevation_mode=drop, "
          f"8 rows): top-1 {top1['native_fov_drop']:.3f}")
    out = {"device": str(device),
           "raw_recall": {str(k): v for k, v in r.items()},
           "n_queries": raw["n_queries"], "gnn_best_r1": gnn_r1,
           "mixed_top1": top1}
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
