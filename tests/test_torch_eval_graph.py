"""The port's forward executables on the CPU, where their static steps run
eagerly: the split-mode eval step (``models/gnn.py`` ``EvalExecutable``,
JAX's ``_jitted_eval_apply``) against JAX through ``from_flax`` weights,
and ``entry()``'s step (``entry.py`` ``ForwardExecutable``) against the
eager step; neither body reads a value back to the host (which would
break a CUDA-graph capture on a card); the split-mode ``warmup()`` builds
every bucket's eval step and the Q = 1 query step, inserts nothing, and
a session afterwards builds none.

Shapes: buckets of 8 and 16 nodes of a 160 → 32 → 160 GNN
(tests/test_torch_serve_graph.py's models and graphs); ``entry()``'s
example at its size (8 scans of 16,384 points). Embeddings against JAX
within 1e-5 (tests/test_torch_gnn.py's eval-forward bar).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax.numpy as jnp  # noqa: E402

from test_torch_online import small_config  # noqa: E402
from test_torch_serve_graph import (  # noqa: E402
    DIM, HOST_SYNCS, _graph, _models, _Ops)
from neural_spectral_codec_tpu.models.gnn import (  # noqa: E402
    _jitted_eval_apply)
from neural_spectral_codec_torch import entry as entry_mod  # noqa: E402
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: E402
    pad_graph)
from neural_spectral_codec_torch.models import (  # noqa: E402
    LocalUpdateGNN, gnn)
from neural_spectral_codec_torch.models.gnn import SpectralGNN  # noqa: E402
from neural_spectral_codec_torch.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline)
from neural_spectral_codec_torch.retrieval import (  # noqa: E402
    retriever as retriever_mod)

torch.set_num_threads(2)
EMB_TOL = 1e-5


@pytest.mark.parametrize("bucket,n", [(8, 5), (8, 8), (16, 12)])
def test_eval_step_matches_jax(bucket, n):
    """``forward_full`` on a padded graph runs the bucket's eval step:
    embeddings within 1e-5 of ``_jitted_eval_apply`` on the same padded
    graph, an eager step counted, the executable cached by bucket and
    model and reused by the next call."""
    jmodel, params, stats, net = _models(bucket + n)
    rng = np.random.default_rng(n)
    g = pad_graph(_graph(rng, n), bucket)
    local = LocalUpdateGNN(net)
    eager = gnn.STATS["eager_steps"]
    got = local.forward_full(g)
    assert gnn.STATS["eager_steps"] == eager + 1
    want = np.asarray(_jitted_eval_apply(jmodel)(
        params, stats, jnp.asarray(g.features), jnp.asarray(g.neighbors),
        jnp.asarray(g.mask), jnp.asarray(g.edge_feats)))
    assert got.shape == (bucket, DIM) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EMB_TOL)
    (exe,) = [e for e in gnn.cached_executables() if e._model() is net]
    assert exe.inputs.dev["features"].shape == (bucket, DIM)
    np.testing.assert_array_equal(local.forward_full(g).numpy(), got.numpy())
    assert [e for e in gnn.cached_executables()
            if e._model() is net] == [exe]


def test_unbucketed_graph_runs_its_bucket_step():
    """A graph whose node count is no bucket (the full graph of
    ``use_local_updates: false``) runs its bucket's eval step: one
    executable of 16 nodes built, one eager step (no op-by-op forward),
    and its 11 rows equal the step's on the same graph padded, which
    reuses that executable."""
    _, _, _, net = _models(4)
    g = _graph(np.random.default_rng(4), 11)
    local = LocalUpdateGNN(net)
    eager, forwards = gnn.STATS["eager_steps"], gnn.STATS["eager_forwards"]
    full = local.forward_full(g)
    assert full.shape == (11, DIM)
    assert gnn.STATS["eager_steps"] == eager + 1
    assert gnn.STATS["eager_forwards"] == forwards
    (exe,) = [e for e in gnn.cached_executables() if e._model() is net]
    assert exe.inputs.dev["features"].shape == (16, DIM)
    padded = local.forward_full(pad_graph(g, 16))
    assert [e for e in gnn.cached_executables() if e._model() is net] \
        == [exe]
    np.testing.assert_array_equal(full.numpy(), padded[:11].numpy())


def _small_entry(seed=0):
    """``entry()``'s step at a small shape: 2 scans of 2,048 points and a
    800 → 32 → 800 GNN."""
    rng = np.random.default_rng(seed)
    from neural_spectral_codec_torch.parallel.dryrun import (
        _example_graph, _example_scans)
    graph = _example_graph(2, rng)
    model = SpectralGNN(hidden_dim=32,
                        generator=torch.Generator().manual_seed(seed)).eval()
    return (torch.from_numpy(_example_scans(2, 2048, rng)),
            torch.tensor(2.0), model,
            torch.from_numpy(graph.neighbors).long(),
            torch.from_numpy(graph.mask),
            torch.from_numpy(graph.edge_feats))


def test_entry_step_equals_the_eager_step():
    """``entry()``'s ``fn`` runs the static step: on its example (8 scans
    of 16,384 points, the full-width GNN) its descriptors and embeddings
    equal ``forward_eager``'s bit for bit on the CPU; the outputs are
    copies (a second call with other scans leaves the first result as it
    was); a repeated shape reuses the executable and another shape builds
    its own."""
    fn, args = entry_mod.entry(device="cpu")
    desc, emb = fn(*args)
    want_d, want_e = entry_mod.forward_eager(*args)
    assert torch.equal(desc, want_d) and torch.equal(emb, want_e)
    keep = desc.clone()
    fn(args[0].flip(0), *args[1:])
    assert torch.equal(desc, keep)
    n = len(entry_mod._CACHE.values())
    small = _small_entry()
    d2, e2 = fn(*small)
    w2 = entry_mod.forward_eager(*small)
    assert torch.equal(d2, w2[0]) and torch.equal(e2, w2[1])
    assert len(entry_mod._CACHE.values()) == n + 1
    fn(*small)
    assert len(entry_mod._CACHE.values()) == n + 1


def _eval_exe():
    """(the executable, its model: held while the step runs)."""
    _, _, _, net = _models(3)
    g = pad_graph(_graph(np.random.default_rng(3), 6), 8)
    LocalUpdateGNN(net).forward_full(g)
    return [e for e in gnn.cached_executables()
            if e._model() is net][0], net


def _entry_exe():
    small = _small_entry(1)
    entry_mod.forward_step(*small)
    return entry_mod.forward_executable(small[0], small[2], small[3],
                                        small[5]), small[2]


@pytest.mark.parametrize("make", [_eval_exe, _entry_exe],
                         ids=["eval", "entry"])
def test_forward_steps_have_no_host_sync(make):
    """The eval and ``entry()`` step bodies dispatch no operation that
    reads a value back to the host, and write the same static buffers
    each run."""
    exe, _model = make()
    ptrs = {k: v.data_ptr() for k, v in exe.outputs.dev.items()}
    with _Ops() as rec:
        exe._step()
    syncs = [op for op in rec.ops if any(s in op for s in HOST_SYNCS)]
    assert rec.ops and not syncs, syncs
    assert {k: v.data_ptr() for k, v in exe.outputs.dev.items()} == ptrs


def test_split_warmup_builds_every_bucket_and_inserts_nothing():
    """``warmup()`` in split mode (``fused_encode`` off) builds the eval
    step of every bucket from 8 up to one beyond its replayed session's
    largest and the Q = 1 query step, and leaves the database as it was;
    a session afterwards builds no eval or query step (the CPU's
    counterpart of no capture mid-stream) and counts one eval step a
    keyframe."""
    from neural_spectral_codec_torch.data.synthetic import SyntheticLoader
    cfg = small_config(retrieval={"icp_max_iterations": 3, "top_k": 3},
                       deployment={"warmup": False, "fused_encode": False,
                                   "fused_query": False})
    pipe = NeuralSpectralCodecPipeline(cfg, device="cpu")
    ret = pipe.retrieval.retriever
    rng = np.random.default_rng(0)
    ret.add_to_database(rng.random((5, DIM)).astype(np.float32),
                        rng.normal(size=(5, 3)).astype(np.float32))
    rows, pos = ret._db_rows.clone(), ret._db_pos.clone()
    pipe.warmup()
    assert ret.database_size == 5
    assert torch.equal(ret._db_rows, rows) and torch.equal(ret._db_pos, pos)
    model = pipe._serving_model()
    mine = [e for e in gnn.cached_executables() if e._model() is model]
    buckets = sorted(e.inputs.dev["features"].shape[0] for e in mine)
    assert len(buckets) >= 3 and buckets == [8 << i
                                            for i in range(len(buckets))]
    queries = [e for e in retriever_mod.cached_executables()
               if e._retriever() is ret]
    assert [(e.n_queries, e.top_k) for e in queries] == [(1, 3)]
    eager0 = gnn.STATS["eager_steps"]
    pipe.run_online(SyntheticLoader(n_frames=40, seed=0, n_points=4096,
                                    loops=2.0), loop_closure_interval=10)
    assert [e for e in gnn.cached_executables() if e._model() is model] \
        == mine
    assert [e for e in retriever_mod.cached_executables()
            if e._retriever() is ret] == queries
    n_kf = len(pipe.selector.keyframes)
    assert n_kf > 10 and gnn.STATS["eager_steps"] - eager0 == n_kf
    assert pipe.profiler.events["midstream_captures"] == 0
    assert pipe.profiler.events.get("query_midstream_captures", 0) == 0
