"""The port's ``cross_sensor_uplift`` experiment against the JAX script
(``experiments/cross_sensor_uplift.py``) on the CPU at 80 frames and one
epoch: the raw Recall@1 on the 64-beam stream and the three mixed-sensor
top-1 shares over 30 places (beam density; native field of view, clip
and drop) equal the JAX script's. The trained GNN's recall differs by
design (other random streams for triplets and dropout): a finite share.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from neural_spectral_codec_torch.experiments import (  # noqa: E402
    cross_sensor_uplift)

torch.set_num_threads(2)
ARGS = ["--frames", "80", "--epochs", "1"]


def test_cross_sensor_numbers_equal_jax_script(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "_jax_exp_cross_sensor_uplift",
        REPO / "experiments" / "cross_sensor_uplift.py")
    jcs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcs)
    raw, _, density, fov, fov_drop = jcs.main(
        ARGS + ["--checkpoint-dir", str(tmp_path / "j")])
    out = cross_sensor_uplift.main(ARGS + ["--device", "cpu"])
    # the JAX recall is a float32 share
    assert np.float32(out["raw_recall"]["1"]) == np.float32(raw)
    assert out["n_queries"] > 0
    assert out["mixed_top1"] == {"beam_density": density,
                                 "native_fov_clip": fov,
                                 "native_fov_drop": fov_drop}
    assert 0.0 <= out["gnn_best_r1"] <= 1.0
