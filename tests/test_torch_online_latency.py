"""The port's online-latency experiment: its built-in configuration
holds configs/inference.yaml's values (the card reads no YAML in
chip_smoke.py), and it runs end to end on the CPU at a small size."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from neural_spectral_codec_torch.experiments import (  # noqa: E402
    online_latency)
from neural_spectral_codec_torch.utils import config as tconfig  # noqa: E402

torch.set_num_threads(2)


def test_inference_config_is_inference_yaml():
    cfg = tconfig.load_config(str(REPO / "configs" / "inference.yaml"))
    for section, values in online_latency.INFERENCE_CONFIG.items():
        for key, value in values.items():
            assert cfg[section][key] == value, (section, key)
    small = online_latency.inference_config(retrieval={"top_k": 3})
    assert small["retrieval"]["spatial_filter_distance"] == 0.0
    assert small["retrieval"]["top_k"] == 3
    assert online_latency.INFERENCE_CONFIG["retrieval"]["top_k"] == 10


@pytest.mark.parametrize("flags", [[], ["--async", "--no-fused-query"]])
def test_online_latency_runs_on_cpu(tmp_path, flags):
    """The entry point at full width on a short, sparse stream: every scan
    a keyframe, a report of latency percentiles and stage means."""
    out = online_latency.main(["--frames", "24", "--n-points", "2048",
                               "--warmup-scans", "4", "--device", "cpu",
                               "--json", str(tmp_path / "o.json")] + flags)
    assert out["keyframes"] == 24 and out["keyframe"]["n"] == 19
    assert out["keyframe"]["p50_ms"] <= out["keyframe"]["max_ms"]
    stage = "encode_graph_update" if flags else "serve_step"
    assert stage in out["stage_mean_ms"] and "select" in out["stage_mean_ms"]
    assert (tmp_path / "o.json").exists() and out["warmup_s"] > 0
