#!/usr/bin/env python3
"""Convert a JAX trainer checkpoint (Orbax) into the PyTorch port's.

    python convert_orbax_checkpoint.py ORBAX_DIR OUT.pt \\
        [--learning-rate 5e-4] [--weight-decay 1e-5]

``ORBAX_DIR`` is a checkpoint that ``neural_spectral_codec_tpu``'s
``GNNTrainer.save_checkpoint`` wrote (params, batch_stats, the optax
state of ``make_optimizer``, meta). ``OUT.pt`` is what the port's
``GNNTrainer.save_checkpoint`` writes, ``{"model", "optimizer",
"meta"}``: ``NeuralSpectralCodecPipeline.load_checkpoint`` serves its
weights and ``GNNTrainer.load_checkpoint`` resumes from it with the same
epoch, step and Adam moments.

The port reads no Orbax and imports no jax, so this runs where jax and
orbax are installed (not on a machine that only serves the port). The
Adam learning rate is the checkpoint's own where it holds one (a
step-decayed schedule), else ``--learning-rate``; the weight decay is
not stored in the optax state and comes from ``--weight-decay``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree if tree is None else np.asarray(tree)


def _adam_state(tree):
    """The ``ScaleByAdamState`` (a dict with count, mu and nu) inside a
    restored optax chain, wherever the chain nests it."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        children = tree.values()
    elif isinstance(tree, list):
        children = tree
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def model_widths(params: dict) -> dict:
    """``SpectralGNN`` arguments that give the parameters' shapes."""
    d0, d1 = params["Dense_0"]["kernel"], params["Dense_1"]["kernel"]
    gat = params["EdgeGATLayer_0"]
    return {"input_dim": d0.shape[0], "hidden_dim": d0.shape[1],
            "output_dim": d1.shape[1],
            "n_layers": sum(k.startswith("EdgeGATLayer_") for k in params),
            "edge_dim": gat["lin_edge"].shape[0] if "lin_edge" in gat
            else None,
            "residual": "residual_proj" in params
            or d0.shape[0] == d1.shape[1]}


def convert(src: str, dst: str, learning_rate: float = 5e-4,
            weight_decay: float = 1e-5) -> dict:
    """Restore ``src`` and write the port checkpoint ``dst``; returns what
    was written."""
    import orbax.checkpoint as ocp
    import torch

    from neural_spectral_codec_torch.models.convert import (
        from_flax, from_optax_adam)
    from neural_spectral_codec_torch.models.gnn import SpectralGNN

    restored = _numpy(ocp.PyTreeCheckpointer().restore(
        str(Path(src).absolute())))
    params, stats = restored["params"], restored["batch_stats"]
    model = SpectralGNN(**model_widths(params))
    model.load_state_dict(from_flax(params, stats))
    opt_state = restored["opt_state"]
    if isinstance(opt_state, dict) and "hyperparams" in opt_state:
        learning_rate = float(opt_state["hyperparams"]["learning_rate"])
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError(f"{src}: no Adam state (count, mu, nu) in its "
                         "optimizer state")
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 weight_decay=weight_decay)
    meta = restored["meta"]
    ckpt = {
        "model": model.state_dict(),
        "optimizer": from_optax_adam(adam["count"], adam["mu"], adam["nu"],
                                     model, optimizer),
        "meta": {
            "epoch": int(meta["epoch"]),
            "global_step": int(meta["global_step"]),
            "best_val_metric": float(meta["best_val_metric"]),
            "epochs_without_improvement":
                int(meta["epochs_without_improvement"]),
            "train_losses": [float(v) for v in
                             np.atleast_1d(meta["train_losses"])],
        },
    }
    Path(dst).parent.mkdir(parents=True, exist_ok=True)
    torch.save(ckpt, dst)
    return ckpt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("orbax_dir")
    ap.add_argument("out_pt")
    ap.add_argument("--learning-rate", type=float, default=5e-4,
                    help="Adam's lr when the checkpoint holds none "
                         "(configs/training.yaml: 5e-4)")
    ap.add_argument("--weight-decay", type=float, default=1e-5,
                    help="Adam's L2 weight decay "
                         "(configs/training.yaml: 1e-5)")
    args = ap.parse_args(argv)
    ckpt = convert(args.orbax_dir, args.out_pt, args.learning_rate,
                   args.weight_decay)
    print(f"wrote {args.out_pt}: epoch {ckpt['meta']['epoch']}, step "
          f"{ckpt['meta']['global_step']}, "
          f"{len(ckpt['model'])} model tensors")
    return ckpt


if __name__ == "__main__":
    main()
