"""Does the GNN improve loop-closure recall over raw descriptors? The port
of ``experiments/degraded_recall.py``.

    python -m neural_spectral_codec_torch.experiments.degraded_recall \\
        [--epochs 15] [--frames 400] [--clean] [--normalize] \\
        [--checkpoint-dir DIR] [--device cuda] [--json out.json]

configs/training.yaml with 16,384 points a scan, a 3 m keyframe distance
and 1024-triplet steps, on synthetic streams of two and a half laps:
``--frames`` training frames (seed 0) and three quarters as many
validation frames (seed 1). By default each scan is degraded
(``DegradedSyntheticLoader``: a random 200° azimuth wedge and 30%
dropout, so a revisit sees another part of the place); ``--clean`` keeps
whole scans, and then the trained GNN must not lose more than 0.02 of the
raw descriptors' Recall@1 (exit code 1 otherwise). Reports the raw
descriptors' Recall@{1,5,10} on the validation keyframes (5 m, 30 frames
apart) and the trained GNN's best validation Recall@1. The descriptors
are encoded on ``--device`` (the projection and spectral kernels on a
card).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import tempfile
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def raw_recall(cfg: Dict, loader, device, ks: Sequence[int]) -> Dict:
    """Recall@k of the raw descriptors of ``loader``'s keyframes (5 m,
    30 frames apart): {"recall": {k: r}, "n_queries": n}."""
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline)
    from neural_spectral_codec_torch.training.validation import (
        recall_loop_closure)
    pipe = NeuralSpectralCodecPipeline(cfg, device=device)
    kfs = pipe._process_sequence(loader, sequence_id=0)
    desc = np.stack([k.descriptor for k in kfs])
    poses = np.stack([k.pose for k in kfs])
    out, nq = {}, 0
    for k in ks:
        out[k], nq = recall_loop_closure(desc, poses, k, 5.0, 30,
                                         device=device)
    return {"recall": out, "n_queries": nq}


def train_best_r1(cfg: Dict, train, val, epochs: int, device) -> float:
    """Train the GNN on ``train`` and return its best validation R@1."""
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline)
    pipe = NeuralSpectralCodecPipeline(cfg, device=device)
    return float(pipe.train_offline([train], [val],
                                    n_epochs=epochs).best_val_metric)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--frames", type=int, default=400)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--clean", action="store_true",
                   help="no degradation: the trained GNN must not lose "
                        "recall against the raw descriptors")
    p.add_argument("--normalize", action="store_true",
                   help="train and evaluate L2-normalised embeddings "
                        "(training.normalize_embeddings)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from neural_spectral_codec_torch.data.synthetic import (
        DegradedSyntheticLoader, SyntheticLoader)
    from neural_spectral_codec_torch.device import resolve_device
    from neural_spectral_codec_torch.utils.config import load_config

    device = resolve_device(args.device)
    cfg = load_config(str(REPO / "configs" / "training.yaml"))
    cfg["encoding"].update({"max_points": 16384})
    cfg["keyframe"].update({"distance_threshold": 3.0})
    cfg["training"].update({"n_epochs": args.epochs,
                            "triplets_per_step": 1024,
                            "patience": args.epochs,
                            "normalize_embeddings": args.normalize})
    loader = SyntheticLoader if args.clean else DegradedSyntheticLoader
    train = loader(n_frames=args.frames, seed=0, n_points=16384, loops=2.5)
    val = loader(n_frames=3 * args.frames // 4, seed=1, n_points=16384,
                 loops=2.5)

    with tempfile.TemporaryDirectory(prefix="nsc_degraded_") as tmp:
        cfg["system"]["checkpoint_dir"] = args.checkpoint_dir or tmp
        raw = raw_recall(cfg, val, device, (1, 5, 10))
        r = raw["recall"]
        print(f"raw descriptors : R@1 {r[1]:.3f}  R@5 {r[5]:.3f}  "
              f"R@10 {r[10]:.3f}  ({raw['n_queries']} queries)")
        gnn_r1 = train_best_r1(cfg, train, val, args.epochs, device)
    print(f"GNN-enhanced    : best R@1 {gnn_r1:.3f} (raw {r[1]:.3f})")
    out = {"device": str(device), "clean": args.clean,
           "raw_recall": {str(k): v for k, v in r.items()},
           "n_queries": raw["n_queries"], "gnn_best_r1": gnn_r1}
    if args.clean:
        out["safety_ok"] = gnn_r1 >= r[1] - 0.02
        print("SAFETY OK: the GNN does not degrade clean-data recall"
              if out["safety_ok"] else "SAFETY FAIL: the GNN degraded "
              f"clean-data recall ({gnn_r1:.3f} < {r[1]:.3f})")
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
    if args.clean and not out["safety_ok"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
