"""GNN training entry point of the port (``train_multi_dataset.py`` of
the JAX package, with ``--device`` in place of ``--platform``):

    python -m neural_spectral_codec_torch.train_multi_dataset \\
        --config configs/training.yaml --synthetic N --epochs E --device cuda

Stages: keyframe selection and descriptors of the training and
validation streams, graph build, GNN training with Recall@K validation
and checkpoints (``<checkpoint_dir>/<name>.pt``, ``metrics.jsonl``).
``main(argv, config=...)`` takes a config dict in place of ``--config``
and returns the trainer, whose ``pipeline`` attribute is the pipeline
that fed it (its encoder's ``path_counts``, its ``stage_seconds``).
Without ``--synthetic`` the streams are the config's
``data.datasets.{train,val}`` sequences (KITTI, NCLT, HeLiPR), read
through ``pipeline._loaders_from_config``.
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Optional

logger = logging.getLogger(__name__)

# vertical fields of view (deg) of known beam counts: VLP-16, HDL-64E
KNOWN_FOV = {16: (-15.0, 15.0), 64: (-24.8, 2.0)}


def main(argv=None, config: Optional[Dict] = None):
    parser = argparse.ArgumentParser(
        description="Train the spectral GNN (PyTorch port)")
    parser.add_argument("--config", default=None,
                        help="YAML config, e.g. configs/training.yaml")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="Override system.checkpoint_dir")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override training.n_epochs")
    parser.add_argument("--resume", default=None, metavar="NAME",
                        help="Resume from <checkpoint_dir>/NAME.pt")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="Train on N synthetic frames (validation on "
                             "max(N // 2, 30))")
    parser.add_argument("--synthetic-beams", type=int, default=None,
                        metavar="B", help="Simulate a B-beam TRAIN sensor")
    parser.add_argument("--synthetic-val-beams", type=int, default=None,
                        metavar="B", help="Simulate a B-beam VAL sensor")
    parser.add_argument("--synthetic-fov", type=float, nargs=2, default=None,
                        metavar=("LO", "HI"),
                        help="Vertical FOV (deg) of the TRAIN sensor; "
                             "needed for beam counts other than 16 and 64")
    parser.add_argument("--synthetic-val-fov", type=float, nargs=2,
                        default=None, metavar=("LO", "HI"),
                        help="Vertical FOV (deg) of the VAL sensor")
    parser.add_argument("--synthetic-sweep-order", action="store_true",
                        help="Emit simulated-sensor scans in sweep order "
                             "(ring-major, azimuth increasing), as a "
                             "spinning LiDAR does, so encoding.ring_major "
                             "can take the ring path")
    parser.add_argument("--device", default="cuda",
                        help="'cuda[:N]' (default) or 'cpu'; no fallback")
    args = parser.parse_args(argv)

    from neural_spectral_codec_torch.data.synthetic import (
        SensorSimLoader, SyntheticLoader)
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline, _loaders_from_config)
    from neural_spectral_codec_torch.utils.config import (
        load_config, validate_config)

    if (args.config is None) == (config is None):
        parser.error("give exactly one of --config and a config dict")
    if config is None:
        config = load_config(args.config)
    else:
        validate_config(config)
        config = {k: dict(v) if isinstance(v, dict) else v
                  for k, v in config.items()}
    if args.checkpoint_dir:
        config.setdefault("system", {})["checkpoint_dir"] = \
            args.checkpoint_dir
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(message)s")

    sensor_flags = (args.synthetic_beams is not None
                    or args.synthetic_val_beams is not None
                    or args.synthetic_fov is not None
                    or args.synthetic_val_fov is not None)
    if sensor_flags and not args.synthetic:
        parser.error("--synthetic-beams/--synthetic-fov flags require "
                     "--synthetic N (they configure the synthetic sensors)")
    if args.synthetic_sweep_order and not sensor_flags:
        parser.error("--synthetic-sweep-order needs a simulated sensor "
                     "(--synthetic-beams B)")
    pipeline = NeuralSpectralCodecPipeline(config, device=args.device)

    n_val = max(args.synthetic // 2, 30)
    if sensor_flags:
        def fov_for(beams, explicit, flag):
            if explicit is not None:
                return tuple(explicit)
            if beams in KNOWN_FOV:
                return KNOWN_FOV[beams]
            parser.error(f"no known vertical FOV for a {beams}-beam "
                         f"sensor; pass {flag} LO HI")

        tb = args.synthetic_beams or 16
        vb = args.synthetic_val_beams or 64
        tf = fov_for(tb, args.synthetic_fov, "--synthetic-fov")
        vf = fov_for(vb, args.synthetic_val_fov, "--synthetic-val-fov")
        logger.info("Synthetic sensors: train %d beams %s deg, val %d "
                    "beams %s deg", tb, tf, vb, vf)
        order = args.synthetic_sweep_order
        train_loaders = [SensorSimLoader(n_frames=args.synthetic, seed=0,
                                         n_beams=tb, beam_fov_deg=tf,
                                         sweep_order=order)]
        val_loaders = [SensorSimLoader(n_frames=n_val, seed=1, n_beams=vb,
                                       beam_fov_deg=vf, sweep_order=order)]
    elif args.synthetic:
        train_loaders = [SyntheticLoader(n_frames=args.synthetic, seed=0)]
        val_loaders = [SyntheticLoader(n_frames=n_val, seed=1)]
    else:
        train_loaders = _loaders_from_config(config, "train")
        val_loaders = _loaders_from_config(config, "val")
    if not train_loaders:
        parser.error("no training datasets in config (data.datasets.train)")

    trainer = pipeline.train_offline(train_loaders, val_loaders,
                                     n_epochs=args.epochs,
                                     resume=args.resume)
    logger.info("Best validation Recall@1: %.4f", trainer.best_val_metric)
    logger.info("Keyframe stats: %s", pipeline.selector.get_statistics())
    trainer.pipeline = pipeline
    return trainer


if __name__ == "__main__":
    main()
