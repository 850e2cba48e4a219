"""PyTorch port vs the JAX reference: the online loop as a whole.
``run_online`` of both pipelines on the same 100-frame synthetic stream
(the JAX ``SyntheticLoader``'s frames through one list-backed loader, the
native verifier on both sides, the JAX GNN weights in the port), then the
port's serving modes against each other: one-dispatch, fused encode,
split, full-graph, background loop closing, the GNN ablation and the
embedding (L2) stage 1."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

from neural_spectral_codec_tpu.data.synthetic import (  # noqa: E402
    SyntheticLoader)
from neural_spectral_codec_tpu.models.gnn import init_gnn  # noqa: E402
from neural_spectral_codec_tpu.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline as JaxPipeline)
from neural_spectral_codec_tpu.utils.config import (  # noqa: E402
    load_config)
from neural_spectral_codec_torch.models import from_flax  # noqa: E402
from neural_spectral_codec_torch.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline)

torch.set_num_threads(2)
CONFIGS = REPO / "configs"
DESC_TOL = 1e-6         # descriptors, port vs JAX on the CPU
T_TOL = 1e-4            # edge transforms (7-DoF), port vs JAX
OPTS = {"spatial_filter_distance": 0.0, "top_k": 3,
        "icp_max_iterations": 10, "verification_max_points": 4096}


def small_config(tmp_path=None, **sections):
    """tests/test_pipeline.py:22's small configuration: 16×90 images, 20
    bins, a 160 → 32 → 160 GNN, 4,096-point scans, 2,000 rows."""
    cfg = load_config(str(CONFIGS / "training.yaml"))
    cfg["encoding"].update({"n_elevation": 16, "n_azimuth": 90, "n_bins": 20,
                            "target_elevation_bins": 8, "max_points": 4096})
    cfg["gnn"].update({"input_dim": 160, "hidden_dim": 32,
                       "output_dim": 160})
    cfg["keyframe"].update({"distance_threshold": 2.0})
    cfg["training"].update({"n_epochs": 2, "triplets_per_step": 256})
    if tmp_path is not None:
        cfg["system"]["checkpoint_dir"] = str(tmp_path / "ckpt")
    cfg["retrieval"]["database_capacity"] = 2000
    cfg["retrieval"].update(OPTS)
    for k, v in sections.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


class ListLoader:
    """Frames held in a list, indexed like a dataset loader."""

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]


@pytest.fixture(scope="module")
def stream():
    base = SyntheticLoader(n_frames=100, seed=0, n_points=4096, loops=2.0)
    return [base[i] for i in range(len(base))]


@pytest.fixture(scope="module")
def jax_run(stream):
    """The JAX pipeline's run_online on the stream, once per module."""
    pipe = JaxPipeline(small_config())
    edges = pipe.run_online(ListLoader(stream), loop_closure_interval=10)
    params, stats = init_gnn(pipe.model, jax.random.key(0))
    weights = from_flax(jax.tree_util.tree_map(np.asarray, params),
                        jax.tree_util.tree_map(np.asarray, stats))
    return pipe, edges, weights


def _port(cfg, weights=None):
    pipe = NeuralSpectralCodecPipeline(cfg, device="cpu")
    if weights is not None:
        pipe.model.load_state_dict(weights)
        pipe.weights_loaded = True
    return pipe


def _key(edges):
    return sorted((e["source_id"], e["target_id"]) for e in edges)


def test_run_online_equals_jax(jax_run, stream, tmp_path):
    """The same keyframe ids, descriptors within 1e-6, embeddings within
    1e-5, stage-1 rows within 1e-6, the same edge set with transforms
    within 1e-4, and the same g2o text."""
    jpipe, jedges, weights = jax_run
    pipe = _port(small_config(), weights)
    edges = pipe.run_online(ListLoader(stream), loop_closure_interval=10,
                            output_g2o=str(tmp_path / "t.g2o"))
    assert pipe.retrieval.verifier.backend == "native"
    assert [k.keyframe_id for k in pipe.selector.keyframes] == \
        [k.keyframe_id for k in jpipe.selector.keyframes]
    for a, b in zip(pipe.selector.keyframes, jpipe.selector.keyframes):
        np.testing.assert_allclose(a.descriptor, b.descriptor, rtol=0,
                                   atol=DESC_TOL)
    for a, b in zip(pipe.graph_manager.keyframes,
                    jpipe.graph_manager.keyframes):
        np.testing.assert_allclose(a.embedding, b.embedding, rtol=0,
                                   atol=1e-5)
    n = jpipe.retrieval.retriever.database_size
    assert pipe.retrieval.retriever.database_size == n
    np.testing.assert_allclose(
        pipe.retrieval.retriever._db_rows[:n].numpy(),
        np.asarray(jpipe.retrieval.retriever._db_cdf[:n]), rtol=0, atol=1e-6)
    assert len(edges) > 0 and _key(edges) == _key(jedges)
    want = {(e["source_id"], e["target_id"]): e for e in jedges}
    for e in edges:
        w = want[(e["source_id"], e["target_id"])]
        np.testing.assert_allclose(e["relative_pose"], w["relative_pose"],
                                   rtol=0, atol=T_TOL)
        assert e["fitness"] >= 0.3 and e["rmse"] <= 0.5
    from neural_spectral_codec_tpu.retrieval.g2o import (
        save_loop_closures_g2o)
    save_loop_closures_g2o(jedges, str(tmp_path / "j.g2o"))
    text = (tmp_path / "t.g2o").read_text()
    assert "EDGE_SE3:QUAT" in text
    assert sorted(text.splitlines()) == sorted(
        (tmp_path / "j.g2o").read_text().splitlines())


@pytest.mark.parametrize("mode", ["one_dispatch_async", "split",
                                  "split_async", "fused_encode",
                                  "full_graph"])
def test_serving_modes_match(jax_run, stream, mode):
    """Every serving mode finds JAX's edge set on the same stream; the
    split chain's database rows equal the one-dispatch rows within 1e-6
    with equal positions (JAX tests/test_pipeline.py:87-161)."""
    jpipe, jedges, weights = jax_run
    deploy = {"one_dispatch_async": {},
              "split": {"fused_query": False},
              "split_async": {"fused_query": False},
              "fused_encode": {"fused_query": False},
              "full_graph": {}}[mode]
    cfg = small_config(deployment=deploy)
    if mode == "split" or mode == "split_async":
        cfg["deployment"]["fused_encode"] = False
    if mode == "full_graph":
        cfg["gnn"]["use_local_updates"] = False
    pipe = _port(cfg, weights)
    edges = pipe.run_online(ListLoader(stream), loop_closure_interval=10,
                            async_loop_closing=mode.endswith("async"))
    assert _key(edges) == _key(jedges)
    assert pipe._n_graph_edge_misses == 0
    n = jpipe.retrieval.retriever.database_size
    np.testing.assert_allclose(
        pipe.retrieval.retriever._db_rows[:n].numpy(),
        np.asarray(jpipe.retrieval.retriever._db_cdf[:n]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        pipe.retrieval.retriever._db_pos[:n].numpy(),
        np.asarray(jpipe.retrieval.retriever._db_pos[:n]))
    sections = set(pipe.profiler.totals)
    assert {"select", "retrieval_add"} <= sections
    assert ("serve_step" in sections) == (mode == "one_dispatch_async")
    assert ("encode_graph_update" in sections) == (mode == "fused_encode")


def test_gnn_ablation_and_embedding_retrieval(jax_run, stream):
    """``ablation.disable_gnn`` serves raw histograms through the split
    path (no embeddings, JAX's edges); ``retrieval.use_embeddings`` ranks
    GNN embeddings by L2 and keeps refreshed rows in sync, with every
    edge verified (JAX tests/test_pipeline.py:253)."""
    jpipe, jedges, weights = jax_run
    pipe = _port(small_config(ablation={"disable_gnn": True}))
    edges = pipe.run_online(ListLoader(stream), loop_closure_interval=10)
    assert _key(edges) == _key(jedges)
    assert all(k.embedding is None for k in pipe.graph_manager.keyframes)
    assert "encode" in pipe.profiler.totals

    cfg = small_config(retrieval={"use_embeddings": True, "top_k": 2,
                                  "context_window": 3})
    pipe = _port(cfg, weights)
    assert pipe.retrieval.stage1_metric == "l2"
    edges = pipe.run_online(ListLoader(stream[:60]), loop_closure_interval=10)
    for e in edges:
        assert e["fitness"] >= 0.3
    kfs = pipe.retrieval.keyframes
    assert kfs[0].embedding is not None
    rows = pipe.retrieval.retriever._db_rows[:len(kfs)].numpy()
    np.testing.assert_allclose(rows[-1], kfs[-1].embedding, atol=1e-6)
    cfg["retrieval"]["storage"] = "uint16"      # L2 rows stay float32
    assert _port(cfg).retrieval.retriever.storage == "float32"


def test_uint16_storage_config(stream):
    """``retrieval.storage: uint16`` reaches the stage-1 database
    (JAX tests/test_pipeline.py:476) and the loop still closes."""
    pipe = _port(small_config(retrieval={"storage": "uint16"}))
    assert pipe.retrieval.retriever._db_rows.dtype == torch.uint16
    edges = pipe.run_online(ListLoader(stream), loop_closure_interval=10)
    assert len(edges) > 0
