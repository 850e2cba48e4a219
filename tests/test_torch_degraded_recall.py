"""The port's ``degraded_recall`` experiment against the JAX script
(``experiments/degraded_recall.py``) on the CPU at 80 frames and one
epoch: the raw descriptors' Recall@{1,5,10} on the degraded validation
stream equal the JAX script's (the same frames, descriptors within 1e-6,
the same revisit queries). The trained GNN's recall differs by design
(JAX and torch draw triplets and dropout from different generators):
it must be a finite share. ``--clean`` reports the safety check.
"""

import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from neural_spectral_codec_torch.experiments import (  # noqa: E402
    degraded_recall)

torch.set_num_threads(2)
ARGS = ["--frames", "80", "--epochs", "1"]


def test_raw_recall_equals_jax_script(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "_jax_exp_degraded_recall", REPO / "experiments" / "degraded_recall.py")
    jdr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdr)
    raw_jax, _ = jdr.main(ARGS + ["--checkpoint-dir", str(tmp_path / "j")])
    out = degraded_recall.main(ARGS + ["--device", "cpu", "--json",
                                       str(tmp_path / "d.json")])
    # the JAX recall is a float32 share
    assert np.float32(out["raw_recall"]["1"]) == np.float32(raw_jax)
    assert out["n_queries"] > 0 and set(out["raw_recall"]) == {"1", "5", "10"}
    assert 0.0 <= out["gnn_best_r1"] <= 1.0
    assert all(math.isfinite(v) for v in out["raw_recall"].values())


def test_clean_mode_reports_safety():
    out = degraded_recall.main(ARGS + ["--clean", "--device", "cpu"])
    assert out["clean"] and out["safety_ok"] in (True, False)
    assert out["raw_recall"]["1"] >= 0.5
