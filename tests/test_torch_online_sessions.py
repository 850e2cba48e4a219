"""The port's online loop across sessions and edge cases, replaying JAX
tests/test_pipeline.py:164-355 and :491-540 on
``neural_spectral_codec_torch``: buffer compaction, warmup without side
effects, checkpoints, monitoring, persistence (resume, autosave, a crash
mid-run) and pathological scans. Stores are compared byte for byte with
the JAX pipeline's where both run the same stream."""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from test_torch_online import ListLoader, small_config  # noqa: E402
from neural_spectral_codec_tpu.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline as JaxPipeline)
from neural_spectral_codec_torch.data.synthetic import (  # noqa: E402
    SyntheticLoader)
from neural_spectral_codec_torch.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline)

torch.set_num_threads(2)


def _pipe(cfg):
    return NeuralSpectralCodecPipeline(cfg, device="cpu")


def test_survives_buffer_compaction():
    """A 12-node window over 120 scans crosses the graph manager's
    64-row compaction and freezes more than 50 nodes."""
    cfg = small_config(keyframe={"max_active_nodes": 12},
                       retrieval={"top_k": 2, "icp_max_iterations": 3})
    pipe = _pipe(cfg)
    pipe.run_online(SyntheticLoader(n_frames=120, seed=0, n_points=2048,
                                    loops=2.0), loop_closure_interval=20,
                    async_loop_closing=True)
    assert len(pipe.selector.keyframes) > 64
    assert len(pipe.graph_manager.keyframes) == 12
    assert len(pipe.graph_manager.frozen_keyframes) > 50
    assert pipe.graph_manager._buf_base > 0


def test_warmup_has_no_side_effect():
    """warmup leaves the database and the graph empty and the loop runs
    after it; with ``deployment.warmup`` run_online calls it."""
    cfg = small_config(retrieval={"icp_max_iterations": 5},
                       deployment={"warmup": True})
    pipe = _pipe(cfg)
    pipe.warmup()
    assert pipe.retrieval.retriever.database_size == 0
    assert not pipe.retrieval.retriever._db_rows.any()
    assert len(pipe.graph_manager.keyframes) == 0
    assert pipe.warmup_seconds > 0
    pipe.run_online(SyntheticLoader(n_frames=30, seed=0, n_points=4096,
                                    loops=2.0), loop_closure_interval=10)
    assert len(pipe.selector.keyframes) == \
        pipe.retrieval.retriever.database_size > 0


def test_checkpoint_roundtrip_through_pipeline(tmp_path):
    """train_offline writes the trainer's .pt checkpoint; load_checkpoint
    (with or without the suffix, or through run_online) restores the same
    weights; a directory (an Orbax checkpoint) raises and names the
    converter command (its conversion: test_torch_orbax_import)."""
    cfg = small_config(tmp_path)
    pipe = _pipe(cfg)
    pipe.train_offline([SyntheticLoader(n_frames=60, seed=0,
                                        n_points=2048)], [], n_epochs=1)
    assert pipe.weights_loaded
    pipe2 = _pipe(small_config(tmp_path))
    assert not pipe2.weights_loaded
    pipe2.load_checkpoint(str(tmp_path / "ckpt" / "final_model"))
    for k, v in pipe.model.state_dict().items():
        assert torch.equal(v.cpu(), pipe2.model.state_dict()[k]), k
    pipe3 = _pipe(small_config(tmp_path))
    pipe3.run_online(SyntheticLoader(n_frames=10, seed=1, n_points=2048),
                     checkpoint_path=str(tmp_path / "ckpt" /
                                         "final_model.pt"))
    assert pipe3.weights_loaded
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(NotImplementedError,
                       match="python convert_orbax_checkpoint.py"):
        pipe2.load_checkpoint(str(tmp_path / "orbax_dir"))
    with pytest.raises(FileNotFoundError):
        pipe2.load_checkpoint(str(tmp_path / "nothing"))


def test_monitoring_budget_and_persistence(tmp_path, caplog):
    """The monitoring line and the latency-budget warning fire; the store
    written at the end equals the JAX pipeline's byte for byte on the
    same stream, and loads back into a fresh retrieval."""
    cfg = small_config(retrieval={"top_k": 2, "icp_max_iterations": 5,
                                  "verification_max_points": 512})
    cfg["monitoring"] = {"enabled": True, "log_interval": 20,
                         "metrics": ["memory_usage"]}
    cfg["deployment"] = {"max_latency_ms": 0.001}
    frames = SyntheticLoader(n_frames=40, seed=0, n_points=4096, loops=2.0)
    frames = [frames[i] for i in range(40)]
    pipe = _pipe(cfg)
    with caplog.at_level(logging.INFO,
                         logger="neural_spectral_codec_torch.pipeline"):
        pipe.run_online(ListLoader(frames), loop_closure_interval=10,
                        database_path=str(tmp_path / "t.bin"))
    assert "monitor @" in caplog.text and "exceeds" in caplog.text
    JaxPipeline(cfg).run_online(ListLoader(frames), loop_closure_interval=10,
                                database_path=str(tmp_path / "j.bin"))
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    from neural_spectral_codec_torch.retrieval.two_stage import (
        TwoStageRetrieval)
    r2 = TwoStageRetrieval(n_bins=pipe.encoder_config.output_dim,
                           capacity=100, device="cpu")
    n = r2.load_database(str(tmp_path / "t.bin"))
    assert n == len(pipe.selector.keyframes) > 0


def test_resume_database_across_sessions(tmp_path):
    """Session 2 resumes session 1's store: the database holds both
    sessions' keyframes, ids continue after the resumed records, and a
    query against point-free records does not fail."""
    db = tmp_path / "map.bin"
    pipe1 = _pipe(small_config(retrieval={"icp_max_iterations": 5}))
    pipe1.run_online(SyntheticLoader(n_frames=40, seed=0, n_points=4096,
                                     loops=1.0), loop_closure_interval=10,
                     database_path=str(db))
    n1 = len(pipe1.selector.keyframes)
    assert db.exists() and n1 > 0
    pipe2 = _pipe(small_config(retrieval={"icp_max_iterations": 5}))
    pipe2.run_online(SyntheticLoader(n_frames=30, seed=0, n_points=4096,
                                     loops=1.0), loop_closure_interval=10,
                     database_path=str(db), resume_database=True)
    n2 = len(pipe2.selector.keyframes)
    assert pipe2.retrieval.retriever.database_size == n1 + n2
    assert pipe2.selector.keyframes[0].keyframe_id == n1
    assert pipe2.retrieval.database_file_records(str(db)) == n1 + n2
    assert isinstance(pipe2.retrieval.query(pipe2.selector.keyframes[-1]),
                      list)


def test_survives_pathological_scans():
    """Empty, all-NaN, single-point and huge-coordinate scans flow
    through selection, encoding (uniform fallback), the graph and
    retrieval; every descriptor is finite and sums to 1."""
    base = SyntheticLoader(n_frames=12, seed=0, n_points=2048, loops=1.0)
    frames = []
    for i in range(12):
        item = base[i]
        item["points"] = {3: np.zeros((0, 4), np.float32),
                          5: np.full((100, 4), np.nan, np.float32),
                          7: np.array([[5.0, 0, 0, 1]], np.float32),
                          9: np.full((50, 4), 1e12, np.float32)
                          }.get(i, item["points"])
        frames.append(item)
    for deploy in ({}, {"fused_query": False, "fused_encode": False}):
        pipe = _pipe(small_config(retrieval={"top_k": 2,
                                             "icp_max_iterations": 3,
                                             "verification_max_points": 512},
                                  deployment=deploy))
        assert isinstance(pipe.run_online(ListLoader(frames),
                                          loop_closure_interval=4), list)
        assert len(pipe.selector.keyframes) > 0
        for kf in pipe.selector.keyframes:
            assert np.isfinite(kf.descriptor).all()
            np.testing.assert_allclose(kf.descriptor.sum(), 1.0, atol=1e-4)


def test_autosave_matches_final_save(tmp_path):
    """Appending every 3 keyframes writes the store the single final save
    writes, byte for byte."""
    paths = []
    for interval in (0, 3):
        cfg = small_config(retrieval={"icp_max_iterations": 5})
        cfg.setdefault("database", {})["autosave_interval"] = interval
        db = tmp_path / f"map_iv{interval}.bin"
        _pipe(cfg).run_online(SyntheticLoader(n_frames=40, seed=0,
                                              n_points=4096, loops=1.0),
                              loop_closure_interval=10,
                              database_path=str(db))
        paths.append(db)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_autosave_survives_crash(tmp_path):
    """A loader that dies mid-run leaves a loadable store with every
    record up to the last autosave; a torn tail is dropped, and a fresh
    session resumes from it."""
    class CrashingLoader(SyntheticLoader):
        def __getitem__(self, idx):
            if idx == 30:
                raise RuntimeError("sensor died")
            return super().__getitem__(idx)

    cfg = small_config(retrieval={"icp_max_iterations": 5},
                       keyframe={"distance_threshold": 1.0})
    cfg.setdefault("database", {})["autosave_interval"] = 2
    pipe = _pipe(cfg)
    db = tmp_path / "map.bin"
    with pytest.raises(RuntimeError, match="sensor died"):
        pipe.run_online(CrashingLoader(n_frames=40, seed=0, n_points=4096,
                                       loops=1.0), loop_closure_interval=10,
                        database_path=str(db), async_loop_closing=True)
    n_file = pipe.retrieval.database_file_records(str(db))
    n_selected = len(pipe.selector.keyframes)
    assert 0 < n_file <= n_selected and n_file >= n_selected - 2
    with open(db, "ab") as f:
        f.write(b"\x00" * 100)                      # a torn record
    pipe2 = _pipe(small_config(retrieval={"icp_max_iterations": 5}))
    pipe2.run_online(SyntheticLoader(n_frames=10, seed=0, n_points=4096,
                                     loops=1.0), loop_closure_interval=10,
                     database_path=str(db), resume_database=True)
    assert pipe2.retrieval.retriever.database_size >= n_file
