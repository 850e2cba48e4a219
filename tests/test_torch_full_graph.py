"""The online loop's full-graph mode (``gnn.use_local_updates: false``) on
the CPU: the whole window, padded to its bucket, runs the bucket's eval
step (``LocalUpdateGNN.forward_full`` → ``gnn.EvalExecutable``), where
JAX's ``gnn_forward`` traces ``_jitted_eval_apply`` at every window size.

Against JAX through ``from_flax`` weights: single forwards on graphs whose
size is no bucket, and every forward of a ``run_online`` session whose
window crosses buckets 8 → 16 → 32. ``warmup()`` in this mode builds the
eval step of every bucket from 8 up to that of ``max_active_nodes`` and
nothing else, leaves the graph and database as they were, and a session
afterwards builds none; a window that never freezes builds one step at
each bucket it crosses past them, counted as a mid-stream capture. The
step body reads nothing back to the host (which would break its
CUDA-graph capture on a card).

Shapes: a 160 → 32 → 160 GNN (tests/test_torch_serve_graph.py's models
and graphs), windows of at most 40 nodes, 4,096-point scans. Embeddings
against JAX within 1e-5 (tests/test_torch_gnn.py's eval-forward bar).
"""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax.numpy as jnp  # noqa: E402

from test_torch_online import ListLoader, small_config  # noqa: E402
from test_torch_serve_graph import (  # noqa: E402
    DIM, HOST_SYNCS, _graph, _models, _Ops)
from neural_spectral_codec_tpu.data.synthetic import (  # noqa: E402
    SyntheticLoader as JaxSyntheticLoader)
from neural_spectral_codec_tpu.models.gnn import (  # noqa: E402
    _jitted_eval_apply)
from neural_spectral_codec_torch.data.synthetic import (  # noqa: E402
    SyntheticLoader)
from neural_spectral_codec_torch.models import (  # noqa: E402
    LocalUpdateGNN, gnn)
from neural_spectral_codec_torch.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline)

torch.set_num_threads(2)
EMB_TOL = 1e-5
WINDOW = 24          # max_active_nodes of the session: buckets 8, 16, 32


def _jax_eval(jmodel, params, stats, g) -> np.ndarray:
    return np.asarray(_jitted_eval_apply(jmodel)(
        params, stats, jnp.asarray(g.features), jnp.asarray(g.neighbors),
        jnp.asarray(g.mask), jnp.asarray(g.edge_feats)))


def _mine(net) -> list:
    return [e for e in gnn.cached_executables() if e._model() is net]


def _buckets(net) -> list:
    return sorted(e.inputs.dev["features"].shape[0] for e in _mine(net))


def _full_graph_pipe(net, **keyframe) -> NeuralSpectralCodecPipeline:
    """A CPU pipeline in full-graph mode with ``net``'s weights."""
    cfg = small_config(gnn={"use_local_updates": False},
                       keyframe=keyframe,
                       retrieval={"icp_max_iterations": 3},
                       deployment={"warmup": False})
    pipe = NeuralSpectralCodecPipeline(cfg, device="cpu")
    pipe.model.load_state_dict(net.state_dict())
    pipe.weights_loaded = True
    return pipe


@pytest.mark.parametrize("n", [5, 11, 23])
def test_unbucketed_forward_matches_jax(n):
    """``forward_full`` on a graph of n nodes (no bucket) returns n rows
    within 1e-5 of ``_jitted_eval_apply`` on the same unpadded graph. It
    builds one executable, of the bucket's size, counted in
    ``STATS["builds"]`` and run as one eager step; another size in the
    same bucket reuses it."""
    jmodel, params, stats, net = _models(n)
    rng = np.random.default_rng(n)
    g = _graph(rng, n)
    local = LocalUpdateGNN(net)
    builds, steps = gnn.STATS["builds"], gnn.STATS["eager_steps"]
    forwards = gnn.STATS["eager_forwards"]
    got = local.forward_full(g)
    assert got.shape == (n, DIM) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), _jax_eval(jmodel, params,
                                                      stats, g),
                               rtol=0, atol=EMB_TOL)
    bucket = LocalUpdateGNN.bucket(n)
    assert _buckets(net) == [bucket]
    assert gnn.STATS["builds"] == builds + 1
    assert gnn.STATS["eager_steps"] == steps + 1
    assert gnn.STATS["eager_forwards"] == forwards
    (exe,) = _mine(net)
    g2 = _graph(rng, n + 1)
    got2 = local.forward_full(g2)
    assert _mine(net) == [exe] and gnn.STATS["builds"] == builds + 1
    np.testing.assert_allclose(got2.numpy(), _jax_eval(jmodel, params,
                                                       stats, g2),
                               rtol=0, atol=EMB_TOL)


@pytest.fixture(scope="module")
def stream():
    base = JaxSyntheticLoader(n_frames=100, seed=0, n_points=4096,
                              loops=2.0)
    return [base[i] for i in range(len(base))]


def _recording(monkeypatch) -> list:
    """Record (graph, embeddings) of every ``forward_full`` call."""
    calls = []
    forward_full = LocalUpdateGNN.forward_full

    def recorded(self, graph):
        out = forward_full(self, graph)
        calls.append((graph, out.numpy().copy()))
        return out

    monkeypatch.setattr(LocalUpdateGNN, "forward_full", recorded)
    return calls


def test_session_equals_jax_on_every_window(stream, monkeypatch):
    """``run_online`` in full-graph mode over test_torch_online.py's
    100-frame stream with a window of 24 nodes (so it crosses buckets 8,
    16 and 32, then freezes a node a keyframe): one forward a keyframe,
    each within 1e-5 of JAX's eval forward on the same unpadded window;
    the active keyframes' embeddings are the last forward's rows and
    within 1e-5 of JAX's eval forward on the final ``get_graph()``, a
    frozen keyframe's its row of the last window that held it; one eval
    step a keyframe, no op-by-op forward; the session finds loop
    closures."""
    jmodel, params, stats, net = _models(7)
    pipe = _full_graph_pipe(net, max_active_nodes=WINDOW)
    calls = _recording(monkeypatch)
    steps, forwards = gnn.STATS["eager_steps"], gnn.STATS["eager_forwards"]
    edges = pipe.run_online(ListLoader(stream), loop_closure_interval=10)
    n_kf = len(pipe.selector.keyframes)
    assert n_kf == len(calls) > 2 * WINDOW and len(edges) > 0
    assert gnn.STATS["eager_steps"] - steps == n_kf
    assert gnn.STATS["eager_forwards"] == forwards
    sizes = [g.n_nodes for g, _ in calls]
    assert sizes == [min(i + 1, WINDOW) for i in range(n_kf)]
    model = pipe._serving_model()
    assert _buckets(model) == [8, 16, 32]
    for g, got in calls:
        np.testing.assert_allclose(got, _jax_eval(jmodel, params, stats, g),
                                   rtol=0, atol=EMB_TOL)
    mgr = pipe.graph_manager
    emb = np.stack([kf.embedding for kf in mgr.keyframes])
    np.testing.assert_array_equal(emb, calls[-1][1])
    np.testing.assert_allclose(emb, _jax_eval(jmodel, params, stats,
                                              mgr.get_graph()),
                               rtol=0, atol=EMB_TOL)
    # a frozen keyframe keeps its row of the last window that held it,
    # where it was the oldest node
    frozen = mgr.frozen_keyframes
    assert len(frozen) == n_kf - WINDOW
    for i, kf in enumerate(frozen):
        np.testing.assert_array_equal(kf.embedding,
                                      calls[i + WINDOW - 1][1][0])


def test_warmup_builds_every_bucket_then_none(caplog):
    """``warmup()`` in full-graph mode builds the eval step of exactly the
    buckets 8 … bucket(max_active_nodes) (max_active_nodes 24: 8, 16, 32)
    and no local-refresh or serving step, leaves the live graph and
    database as they were, and builds the Q = 1 query step; a session
    afterwards builds no step, runs one eval step a keyframe and counts no
    mid-stream capture."""
    from neural_spectral_codec_torch.models import serving
    from neural_spectral_codec_torch.retrieval import (
        retriever as retriever_mod)
    _, _, _, net = _models(8)
    pipe = _full_graph_pipe(net, max_active_nodes=WINDOW)
    ret = pipe.retrieval.retriever
    rng = np.random.default_rng(0)
    ret.add_to_database(rng.random((5, DIM)).astype(np.float32),
                        rng.normal(size=(5, 3)).astype(np.float32))
    rows, pos = ret._db_rows.clone(), ret._db_pos.clone()
    serving_builds = serving.STATS["builds"]
    pipe.warmup()
    model = pipe._serving_model()
    assert _buckets(model) == [8, 16, 32]
    assert serving.STATS["builds"] == serving_builds
    assert pipe.graph_manager.keyframes == []
    assert pipe.graph_manager.get_graph() is None
    assert ret.database_size == 5
    assert torch.equal(ret._db_rows, rows) and torch.equal(ret._db_pos, pos)
    queries = [e for e in retriever_mod.cached_executables()
               if e._retriever() is ret]
    assert [(e.n_queries, e.top_k) for e in queries] == [(1, 3)]
    mine = _mine(model)
    builds, steps = gnn.STATS["builds"], gnn.STATS["eager_steps"]
    with caplog.at_level(logging.WARNING):
        pipe.run_online(SyntheticLoader(n_frames=40, seed=0, n_points=4096,
                                        loops=2.0), loop_closure_interval=10)
    n_kf = len(pipe.selector.keyframes)
    assert n_kf > WINDOW and _mine(model) == mine
    assert gnn.STATS["builds"] == builds
    assert gnn.STATS["eager_steps"] - steps == n_kf
    assert pipe.profiler.events["midstream_captures"] == 0
    assert pipe.profiler.events.get("query_midstream_captures", 0) == 0
    assert "mid-stream" not in caplog.text


def test_unfrozen_window_builds_one_step_a_bucket_crossed(caplog):
    """With ``freeze_old_embeddings: false`` the window grows without
    bound: after ``warmup()`` (max_active_nodes 16: buckets 8 and 16) a
    40-keyframe session builds exactly one step at each bucket it
    crosses (32 at 17 nodes, 64 at 33), each counted in
    ``profiler.events["midstream_captures"]`` and logged."""
    _, _, _, net = _models(9)
    pipe = _full_graph_pipe(net, max_active_nodes=16,
                            freeze_old_embeddings=False)
    pipe.warmup()
    model = pipe._serving_model()
    assert _buckets(model) == [8, 16]
    builds = gnn.STATS["builds"]
    with caplog.at_level(logging.WARNING):
        pipe.run_online(SyntheticLoader(n_frames=40, seed=0, n_points=4096,
                                        loops=2.0), loop_closure_interval=10)
    assert len(pipe.graph_manager.keyframes) == 40
    assert pipe.graph_manager.frozen_keyframes == []
    assert _buckets(model) == [8, 16, 32, 64]
    assert gnn.STATS["builds"] - builds == 2
    assert pipe.profiler.events["midstream_captures"] == 2
    assert caplog.text.count("captured mid-stream") == 2


def test_full_graph_step_has_no_host_sync():
    """The step ``forward_full`` runs for a 23-node graph (bucket 32)
    dispatches no operation that reads a value back to the host, and
    writes the same static buffers each run."""
    _, _, _, net = _models(10)
    LocalUpdateGNN(net).forward_full(_graph(np.random.default_rng(10), 23))
    (exe,) = _mine(net)
    ptrs = {k: v.data_ptr() for k, v in exe.outputs.dev.items()}
    with _Ops() as rec:
        exe._step()
    syncs = [op for op in rec.ops if any(s in op for s in HOST_SYNCS)]
    assert rec.ops and not syncs, syncs
    assert {k: v.data_ptr() for k, v in exe.outputs.dev.items()} == ptrs
