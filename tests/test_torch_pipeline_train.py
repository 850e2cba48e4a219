"""PyTorch port vs the JAX reference: the offline training path. Synthetic
streams, pose math, keyframe selection, configs and graph helpers are
numpy copies and must equal the JAX package's; ``_process_sequence``
selects the same scans, with descriptors within 1e-5 and the same
graph; ``train_multi_dataset.main`` trains on the CPU and writes its
checkpoints."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from neural_spectral_codec_tpu.data import pose_utils as jpose  # noqa: E402
from neural_spectral_codec_tpu.data import synthetic as jsyn  # noqa: E402
from neural_spectral_codec_tpu.keyframe import graph as jgraph  # noqa: E402
from neural_spectral_codec_tpu.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline as JaxPipeline)
from neural_spectral_codec_tpu.utils import config as jconfig  # noqa: E402
from neural_spectral_codec_torch import train_multi_dataset  # noqa: E402
from neural_spectral_codec_torch.data import pose_utils as tpose  # noqa: E402
from neural_spectral_codec_torch.data import synthetic as tsyn  # noqa: E402
from neural_spectral_codec_torch.keyframe import graph as tgraph  # noqa: E402
from neural_spectral_codec_torch.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig)
from neural_spectral_codec_torch.pipeline import (  # noqa: E402
    BatchEncoder, NeuralSpectralCodecPipeline, RingMajorBatchEncoder)
from neural_spectral_codec_torch.utils import config as tconfig  # noqa: E402

torch.set_num_threads(2)
CONFIGS = REPO / "configs"


def _small_config(tmp_path, **sections):
    cfg = jconfig.load_config(str(CONFIGS / "training.yaml"))
    cfg["encoding"].update({"n_azimuth": 90, "n_bins": 20,
                            "target_elevation_bins": 8, "max_points": 4096})
    cfg["gnn"].update({"input_dim": 160, "hidden_dim": 32,
                       "output_dim": 160})
    cfg["keyframe"].update({"distance_threshold": 5.0})
    cfg["training"].update({"triplets_per_step": 256})
    cfg["system"]["checkpoint_dir"] = str(tmp_path / "ckpt")
    cfg["retrieval"]["database_capacity"] = 256
    for k, v in sections.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


def test_synthetic_streams_equal_jax():
    """SyntheticLoader and SensorSimLoader (with wedge and dropout) give
    the JAX package's items bit for bit; ``sweep_order`` permutes the
    same points into ring-major, azimuth-increasing order."""
    for i in (0, 7):
        a, b = tsyn.SyntheticLoader(12, seed=3, n_points=2048)[i], \
            jsyn.SyntheticLoader(12, seed=3, n_points=2048)[i]
        for k in ("points", "pose", "timestamp", "idx"):
            np.testing.assert_array_equal(a[k], b[k])
    kw = dict(n_frames=6, seed=5, n_points=3000, n_beams=16, wedge_deg=200.0,
              dropout=0.2)
    got, want = tsyn.SensorSimLoader(**kw)[4], jsyn.SensorSimLoader(**kw)[4]
    np.testing.assert_array_equal(got["points"], want["points"])
    swept = tsyn.SensorSimLoader(**kw, sweep_order=True)[4]["points"]
    np.testing.assert_array_equal(
        swept[np.lexsort(swept.T)], want["points"][np.lexsort(
            want["points"].T)])
    el = np.arctan2(swept[:, 2], np.hypot(swept[:, 0], swept[:, 1]))
    assert np.all(np.diff(el) > -1e-4)              # rings bottom-up
    np.testing.assert_array_equal(tsyn.loop_trajectory(50, 30.0, 1.5),
                                  jsyn.loop_trajectory(50, 30.0, 1.5))


def test_pose_utils_equal_jax():
    """The SE(3) helpers and the voxel-IoU overlap equal the JAX
    package's on random poses and clouds."""
    rng = np.random.default_rng(0)
    poses = jsyn.loop_trajectory(8, 20.0, 1.0)
    poses[:, :3, 3] += rng.normal(0, 0.3, (8, 3))
    a, b = poses[1], poses[5]
    pts = rng.normal(0, 5, (6000, 4))
    for name in ("relative_pose", "compose_poses", "euclidean_distance",
                 "rotation_angle", "rotation_angle_degrees",
                 "pose_difference", "euclidean_distance_batch",
                 "rotation_angle_batch"):
        np.testing.assert_array_equal(getattr(tpose, name)(a, b),
                                      getattr(jpose, name)(a, b), name)
    np.testing.assert_array_equal(tpose.inverse_pose(poses),
                                  jpose.inverse_pose(poses))
    np.testing.assert_allclose(tpose.interpolate_poses(a, b, 0.3),
                               jpose.interpolate_poses(a, b, 0.3), atol=0)
    np.testing.assert_array_equal(tpose.pose_to_7dof(a),
                                  jpose.pose_to_7dof(a))
    np.testing.assert_array_equal(tpose.transform_points(pts, a),
                                  jpose.transform_points(pts, a))
    np.testing.assert_array_equal(tpose.cartesian_to_spherical(pts),
                                  jpose.cartesian_to_spherical(pts))
    assert tpose.is_valid_transformation(a) and \
        not tpose.is_valid_transformation(a * 1.1)
    T = tpose.relative_pose(a, poses[2])
    assert tpose.compute_overlap(pts, pts[::-1], T) == \
        jpose.compute_overlap(pts, pts[::-1], T)


def test_configs_equal_jax(monkeypatch):
    """``load_config`` resolves ``inherit`` as the JAX package does;
    ``validate_config`` rejects what it rejects; without PyYAML
    ``load_config`` raises ImportError instead of guessing."""
    for name in ("training.yaml", "training_multi_dataset.yaml",
                 "inference.yaml"):
        assert tconfig.load_config(str(CONFIGS / name)) == \
            jconfig.load_config(str(CONFIGS / name))
    bad = {"gnn": {"hidden_dim": 2.5}}
    with pytest.raises(tconfig.ConfigError, match="hidden_dim"):
        tconfig.validate_config(bad)
    with pytest.raises(tconfig.ConfigError, match="min_range"):
        tconfig.validate_config({"encoding": {"min_range": 5.0,
                                              "max_range": 2.0}})
    cfg = tconfig.load_config(str(CONFIGS / "training.yaml"))
    assert tconfig.get(cfg, "training.triplets_per_step") == 4096
    assert tconfig.get(cfg, "training.missing", 7) == 7
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        tconfig.load_config(str(CONFIGS / "training.yaml"))


def test_graph_helpers_equal_jax():
    """pad_graph and graph_to_coo equal the JAX package's."""
    rng = np.random.default_rng(1)
    desc = rng.random((20, 6)).astype(np.float32)
    poses = jsyn.loop_trajectory(20, 30.0, 2.0)
    g = tgraph.build_graph(desc, poses, loop_closures=[(0, 10), (3, 13)])
    jg = jgraph.build_graph(desc, poses, loop_closures=[(0, 10), (3, 13)])
    for got, want in zip(tgraph.pad_graph(g, 24), jgraph.pad_graph(jg, 24)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tgraph.graph_to_coo(g), jgraph.graph_to_coo(jg)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tgraph.pad_graph(g, 10)


def test_process_sequence_matches_jax(tmp_path):
    """On a tight loop (3.1 m and 9° per frame, distance threshold 5 m)
    the voxel-IoU check (threshold 0.015) decides each scan one frame past
    a keyframe, keeping some and dropping others, and the distance the
    scan after a dropped one. The port selects the JAX pipeline's scans
    with the same selector statistics; its
    descriptors are within 1e-5 of JAX's and its graph is
    ``build_graph_from_keyframes`` of JAX's keyframes (features 1e-5,
    the rest equal)."""
    cfg = _small_config(tmp_path, keyframe={"overlap_threshold": 0.015})
    loader = tsyn.SyntheticLoader(n_frames=40, seed=0, n_points=2048,
                                  radius=20.0, loops=1.0)
    jloader = jsyn.SyntheticLoader(n_frames=40, seed=0, n_points=2048,
                                   radius=20.0, loops=1.0)
    pipe = NeuralSpectralCodecPipeline(cfg, device="cpu")
    jpipe = JaxPipeline(cfg)
    kfs = pipe._process_sequence(loader)
    jkfs = jpipe._process_sequence(jloader)
    assert [k.scan_id for k in kfs] == [k.scan_id for k in jkfs]
    assert pipe.selector.get_statistics() == jpipe.selector.get_statistics()
    counts = pipe.selector.get_statistics()["criteria_counts"]
    assert counts["geometric"] > 5 and counts["distance"] > 5 and len(kfs) < 40
    desc = np.stack([k.descriptor for k in kfs])
    np.testing.assert_allclose(desc, np.stack([k.descriptor for k in jkfs]),
                               rtol=0, atol=1e-5)
    got = tgraph.build_graph_from_keyframes(kfs)
    want = jgraph.build_graph_from_keyframes(jkfs)
    np.testing.assert_allclose(got.features, want.features, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    assert pipe.encoder.path_counts == {"ring": 0, "general": len(kfs)}


def test_ring_major_encoder_matches_general():
    """64-beam HDL-64E-like scans in sweep order: every scan takes the
    ring path of ``RingMajorBatchEncoder`` (batches of 8 and a partial
    one) with descriptors within 1e-6 of the general encoder's; the same
    scans in the JAX stream's random order all fall back to the general
    path."""
    loader = tsyn.SensorSimLoader(n_frames=10, seed=2, n_points=4096,
                                  n_beams=64, beam_fov_deg=(-24.8, 2.0),
                                  sweep_order=True)
    clouds = [loader[i]["points"] for i in range(10)]
    cfg = SpectralEncoderConfig(n_elevation=64)
    ring = RingMajorBatchEncoder(cfg, max_points=8192, device="cpu")
    base = BatchEncoder(cfg, max_points=8192, batch_size=4,
                        device="cpu")
    got, want = ring.encode(clouds), base.encode(clouds)
    assert ring.path_counts == {"ring": 10, "general": 0}
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rng = np.random.default_rng(0)
    shuffled = [c[rng.permutation(len(c))] for c in clouds[:2]]
    np.testing.assert_allclose(ring.encode(shuffled), want[:2], atol=1e-6)
    assert ring.path_counts == {"ring": 10, "general": 2}


def test_mixed_precision_and_ablation_raise(tmp_path):
    """``training.mixed_precision`` builds the GNN with a bf16 compute
    dtype (float32 parameters; the numbers: test_torch_mixed_precision);
    a disabled GNN has nothing to train (ValueError)."""
    mp = NeuralSpectralCodecPipeline(_small_config(
        tmp_path, training={"mixed_precision": True}), device="cpu")
    assert mp.model.compute_dtype is torch.bfloat16
    assert all(p.dtype == torch.float32 for p in mp.model.parameters())
    assert NeuralSpectralCodecPipeline(_small_config(tmp_path),
                                       device="cpu").model.compute_dtype \
        is None
    pipe = NeuralSpectralCodecPipeline(_small_config(
        tmp_path, ablation={"disable_gnn": True}), device="cpu")
    with pytest.raises(ValueError, match="disable_gnn"):
        pipe.train_offline([tsyn.SyntheticLoader(4, n_points=256)])


def test_train_multi_dataset_trains_and_resumes(tmp_path):
    """``main`` with configs/training.yaml, 120 synthetic frames (two
    laps: the second lap gives the positives) and one epoch on the CPU:
    full-width training on 120 keyframes with validation on 60, then
    final_model.pt and metrics.jsonl; a second call resumes from
    final_model.pt and trains one more epoch."""
    ckpt = tmp_path / "ckpt"
    args = ["--config", str(CONFIGS / "training.yaml"), "--synthetic",
            "120", "--epochs", "1", "--device", "cpu", "--checkpoint-dir",
            str(ckpt)]
    trainer = train_multi_dataset.main(args)
    assert (ckpt / "final_model.pt").exists()
    recs = [json.loads(line) for line in
            (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert recs[0]["train_loss"] > 0 and np.isfinite(recs[0]["train_loss"])
    assert recs[1]["n_queries"] > 0
    assert trainer.global_step == 1 and trainer.model.input_proj.in_features \
        == 800
    state = torch.load(ckpt / "final_model.pt", weights_only=True)["model"]
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(state[k], v), k
    again = train_multi_dataset.main(args + ["--resume", "final_model"])
    assert again.global_step == 2 and len(again.train_losses) == 2


def test_train_multi_dataset_ring_major_stream(tmp_path):
    """A config dict (no YAML) with ``encoding.ring_major`` and 64 image
    rows, on 64-beam sweep-ordered sensor streams: every train and val
    scan takes the ring path; bad flag combinations are refused."""
    cfg = jconfig.load_config(str(CONFIGS / "training.yaml"))
    cfg["encoding"].update({"ring_major": True, "n_elevation": 64,
                            "max_points": 16384})
    args = ["--synthetic", "40", "--synthetic-beams", "64",
            "--synthetic-sweep-order", "--epochs", "1", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    trainer = train_multi_dataset.main(args, config=cfg)
    assert trainer.pipeline.encoder.path_counts == {"ring": 70, "general": 0}
    assert (tmp_path / "ckpt" / "final_model.pt").exists()
    with pytest.raises(SystemExit):
        train_multi_dataset.main(args)                  # no config at all
    with pytest.raises(SystemExit):
        train_multi_dataset.main(["--synthetic", "40",
                                  "--synthetic-sweep-order"], config=cfg)


def test_chip_smoke_config_is_training_yaml():
    """The config dict ``chip_smoke.py`` trains with on the card (which
    has no PyYAML) holds configs/training.yaml's values."""
    import chip_smoke
    cfg = tconfig.load_config(str(CONFIGS / "training.yaml"))
    for section, values in chip_smoke.TRAINING_CONFIG.items():
        for key, value in values.items():
            assert cfg[section][key] == value, (section, key)
