"""The port's serving executables (``models/serving.py``) on the CPU, where
the static step runs eagerly with the kernels' plain versions: the step
against JAX's one-dispatch ``_jitted_serving_step`` and
``_jitted_fused_encode_apply``, the absence of host syncs (which would
break a CUDA-graph capture on a card), side-effect-free warm-up, and the
executable cache's keys."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import synthetic_scan  # noqa: E402
from test_torch_encode import nudge_points  # noqa: E402
from test_torch_online import small_config  # noqa: E402
from neural_spectral_codec_tpu.data.synthetic import (  # noqa: E402
    loop_trajectory)
from neural_spectral_codec_tpu.models.gnn import (  # noqa: E402
    SpectralGNN as JaxGNN, _jitted_fused_encode_apply, _jitted_serving_step,
    init_gnn)
from neural_spectral_codec_tpu.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig as JaxEncConfig)
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: E402
    TemporalGraphManager, build_graph, pad_graph)
from neural_spectral_codec_torch.keyframe.selector import Keyframe  # noqa: E402
from neural_spectral_codec_torch.models import (  # noqa: E402
    LocalUpdateGNN, SpectralGNN, from_flax, serving)
from neural_spectral_codec_torch.ops.range_image import pad_points  # noqa: E402
from neural_spectral_codec_torch.ops.ring_path import (  # noqa: E402
    make_structured_ring_scans)
from neural_spectral_codec_torch.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig)
from neural_spectral_codec_torch.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline)
from neural_spectral_codec_torch.retrieval import (  # noqa: E402
    WassersteinRetriever)
from neural_spectral_codec_torch.retrieval.two_stage import (  # noqa: E402
    TwoStageRetrieval)

torch.set_num_threads(2)

ENC = dict(n_elevation=16, n_azimuth=90, n_bins=20, target_elevation_bins=8)
DIM = 160
DESC_TOL = 1e-6          # descriptors on nudged points
EMB_TOL = 1e-5           # embeddings, port vs JAX (float32 GNN)
# stage-1 distances, relative, as test_torch_serve.test_query_matches_jax:
# the two frameworks' query CDFs differ by ~1e-7 a bin (descriptors within
# DESC_TOL, summed in other orders), and a W₁ distance sums 160 such bins
DIST_RTOL = 2e-5
CPU = torch.device("cpu")
HOST_SYNCS = ("_local_scalar_dense", "is_nonzero", "nonzero", ".item")


def _models(seed=0):
    """JAX and port GNNs (160 → 32 → 160, 3 layers) with the same weights
    and random BatchNorm running statistics."""
    jmodel = JaxGNN(input_dim=DIM, hidden_dim=32, output_dim=DIM)
    params, stats = init_gnn(jmodel, jax.random.key(seed))
    stats = jax.tree_util.tree_map(np.asarray, stats)
    rng = np.random.default_rng(seed)
    for bn in stats.values():
        bn["mean"] = rng.normal(0, 0.05, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    net = SpectralGNN(input_dim=DIM, hidden_dim=32, output_dim=DIM)
    net.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params),
                                  stats))
    return jmodel, params, stats, net.eval()


def _graph(rng, n):
    """A keyframe graph of ``n`` nodes on a line with two loop edges."""
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = np.arange(n) * 3.0
    h = rng.random((n, DIM)).astype(np.float32) ** 4
    return build_graph(h / h.sum(axis=1, keepdims=True), poses,
                       loop_closures=[(0, n - 1), (1, n // 2)])


def _scan(rng, enc):
    return nudge_points(synthetic_scan(rng, 1024), enc.projection)


def _jax_rows(ret, n):
    """The port's first ``n`` stored rows and positions as JAX buffers of
    the retriever's capacity (uint16 codes as uint16)."""
    rows = ret._db_rows
    if rows.dtype == torch.uint16:
        rows = rows.view(torch.int16).numpy().view(np.uint16)
    else:
        rows = rows.numpy()
    return jnp.asarray(rows.copy()), jnp.asarray(ret._db_pos.numpy().copy())


def _row_np(ret, i):
    r = ret._db_rows[i]
    return (r.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
            if r.dtype == torch.uint16 else r.numpy())


def _run(exe, ret, pts, g, center, qp, do_query, window):
    """One serving step through the executable under ``fused_dispatch``
    (which hands ``insert_at`` and ``eff_size`` to the staging)."""
    def dispatch(insert_at, eff):
        exe.stage(pts, g, center, insert_at, eff, qp, qp[:3])
        return {k: v.copy() for k, v in exe.execute().items()}
    return ret.fused_dispatch(dispatch, insert=True,
                              exclude_last=window - 1 if do_query else 0)


@pytest.mark.parametrize("metric,storage", [("wasserstein", "float32"),
                                            ("wasserstein", "uint16"),
                                            ("l2", "float32")])
def test_static_step_matches_jax_serving_step(metric, storage):
    """Four steps of the static step (eager on the CPU) against JAX's
    ``_jitted_serving_step`` on the same inputs: buckets 16 and 8, each
    with the query on and off, graphs staged unpadded into the bucket
    (a smaller graph after a larger one: the pad rows are cleared) and
    padded on the JAX side. Descriptors <= 1e-6, the bucket's embeddings
    <= 1e-5, indices equal, distances within 2e-5 relative; the inserted row
    is byte-equal to the encoding of the step's own vector and within 1e-6
    of JAX's (uint16: one code; L2 rows are embeddings: 1e-5)."""
    jmodel, params, stats, net = _models(1)
    jenc = JaxEncConfig(use_pallas=False, **ENC)
    enc = SpectralEncoderConfig(**ENC)
    rng = np.random.default_rng(7)
    cap, n0, k, window = 48, 20, 5, 3
    ret = WassersteinRetriever(n_bins=DIM, capacity=cap, metric=metric,
                               storage=storage, device="cpu")
    h = rng.random((n0, DIM)).astype(np.float32) ** 4
    pos = rng.uniform(-40, 40, (n0, 3)).astype(np.float32)
    ret.add_to_database(h / h.sum(axis=1, keepdims=True), pos)
    db, db_pos = _jax_rows(ret, n0)
    steps = [(14, 16, True), (6, 8, False), (10, 16, False), (7, 8, True)]
    serving.clear_cache()
    for i, (n, bucket, do_query) in enumerate(steps):
        g = _graph(rng, n)
        pts = _scan(rng, enc)
        center = i % n
        qp = np.array([*pos[i], 10.0 if i % 2 == 0 else 0.0], np.float32)
        size = ret.database_size
        shape = serving.step_shape(pts.shape, bucket, g.max_degree, 2, enc,
                                   2.0, top_k=k, do_query=do_query,
                                   do_insert=True)
        exe = serving.executable(net, ret, shape, CPU)
        out = _run(exe, ret, pts, g, center, qp, do_query, window)
        pg = pad_graph(g, bucket)
        step = _jitted_serving_step(jmodel, jenc, k, metric, storage, 1e-8,
                                    do_query, True)
        got = step(db, db_pos, jnp.asarray(pts), jnp.float32(2.0), params,
                   stats, jnp.asarray(pg.features),
                   jnp.asarray(pg.neighbors), jnp.asarray(pg.mask),
                   jnp.asarray(pg.edge_feats), jnp.int32(center),
                   jnp.int32(size),
                   jnp.int32(max(size - (window - 1 if do_query else 0), 0)),
                   jnp.asarray(qp), jnp.asarray(qp[:3]))
        db, db_pos, jdesc, jemb = got[:4]
        np.testing.assert_allclose(out["desc"], np.asarray(jdesc), rtol=0,
                                   atol=DESC_TOL)
        np.testing.assert_allclose(out["emb"], np.asarray(jemb), rtol=0,
                                   atol=EMB_TOL)
        assert out["emb"].shape == (bucket, DIM)
        if do_query:
            jidx, jdist = (np.asarray(a) for a in got[4:])
            np.testing.assert_array_equal(out["idx"], jidx)
            np.testing.assert_allclose(out["dist"], jdist, rtol=DIST_RTOL,
                                       atol=0)
        else:
            assert "idx" not in out and "dist" not in out
        # the step's scalars are device values staged with the inputs
        np.testing.assert_array_equal(
            exe.inputs.dev["scalars"].numpy(),
            [center, size, max(size - (window - 1 if do_query else 0), 0)])
        assert ret.database_size == size + 1
        vec = out["emb"][center] if metric == "l2" else out["desc"]
        want = ret.encode_rows(torch.from_numpy(vec)[None])[0]
        assert torch.equal(ret._db_rows[size].view(torch.int16)
                           if storage == "uint16" else ret._db_rows[size],
                           want.view(torch.int16)
                           if storage == "uint16" else want)
        jrow = np.asarray(db[size]).astype(
            np.int64 if storage == "uint16" else np.float32)
        if storage == "uint16":
            assert np.abs(_row_np(ret, size) - jrow).max() <= 1
        else:
            np.testing.assert_allclose(
                _row_np(ret, size), jrow, rtol=0,
                atol=EMB_TOL if metric == "l2" else DESC_TOL)
        np.testing.assert_array_equal(ret._db_pos[size].numpy(), qp[:3])
    assert len(serving.cached_executables()) == 4


@pytest.mark.parametrize("bucket,n", [(8, 5), (16, 12)])
def test_fused_encode_step_matches_jax(bucket, n):
    """The executable without a retriever (encode + local refresh) against
    JAX's ``_jitted_fused_encode_apply`` on the padded graph: descriptor
    <= 1e-6, the bucket's embeddings <= 1e-5."""
    jmodel, params, stats, net = _models(2)
    jenc = JaxEncConfig(use_pallas=False, **ENC)
    enc = SpectralEncoderConfig(**ENC)
    rng = np.random.default_rng(bucket)
    g = _graph(rng, n)
    pts = _scan(rng, enc)
    shape = serving.step_shape(pts.shape, bucket, g.max_degree, 2, enc, 2.0)
    exe = serving.executable(net, None, shape, CPU)
    exe.stage(pts, g, 3)
    out = exe.execute()
    pg = pad_graph(g, bucket)
    jdesc, jemb = _jitted_fused_encode_apply(jmodel, jenc)(
        jnp.asarray(pts), jnp.float32(2.0), params, stats,
        jnp.asarray(pg.features), jnp.asarray(pg.neighbors),
        jnp.asarray(pg.mask), jnp.asarray(pg.edge_feats), jnp.int32(3))
    np.testing.assert_allclose(out["desc"], np.asarray(jdesc), rtol=0,
                               atol=DESC_TOL)
    np.testing.assert_allclose(out["emb"], np.asarray(jemb), rtol=0,
                               atol=EMB_TOL)


class _Ops(TorchDispatchMode):
    """Records the name of every aten operation dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("form,metric,storage", [
    ("general", "wasserstein", "float32"), ("ring", "wasserstein", "uint16"),
    ("general", "l2", "float32")])
def test_static_step_has_no_host_sync(form, metric, storage):
    """One static step (query and insert on) dispatches no operation that
    reads a value back to the host (``_local_scalar_dense``,
    ``is_nonzero``, ``nonzero``, ``item``): on a card any of them would
    break the CUDA-graph capture. Two runs leave the outputs in the same
    static buffers."""
    net = SpectralGNN(input_dim=DIM, hidden_dim=32, output_dim=DIM,
                      generator=torch.Generator().manual_seed(0)).eval()
    enc = SpectralEncoderConfig(**ENC)
    rng = np.random.default_rng(3)
    ret = WassersteinRetriever(n_bins=DIM, capacity=16, metric=metric,
                               storage=storage, device="cpu")
    ret.add_to_database(rng.random((6, DIM)).astype(np.float32),
                        rng.normal(size=(6, 3)).astype(np.float32))
    g = _graph(rng, 8)
    if form == "ring":
        pts = make_structured_ring_scans(1, 16, 64, enc.projection,
                                         seed=4)[0]
        rows = tuple(range(16))
    else:
        pts, rows = _scan(rng, enc), None
    shape = serving.step_shape(pts.shape, 8, g.max_degree, 2, enc, 2.0,
                               rows, 2, 4, True, True)
    exe = serving.executable(net, ret, shape, CPU)
    exe.stage(pts, g, 2, 6, 4, np.array([0, 0, 0, 5], np.float32))
    ptrs = {k: v.data_ptr() for k, v in exe.outputs.dev.items()}
    with _Ops() as rec:
        first = exe.execute()
    syncs = [op for op in rec.ops if any(s in op for s in HOST_SYNCS)]
    assert rec.ops and not syncs, syncs
    addr = {k: v.__array_interface__["data"][0] for k, v in first.items()}
    desc = first["desc"].copy()
    second = exe.execute()
    assert {k: v.data_ptr() for k, v in exe.outputs.dev.items()} == ptrs
    assert {k: v.__array_interface__["data"][0]
            for k, v in second.items()} == addr
    np.testing.assert_array_equal(second["desc"], desc)


def _one_dispatch_pipe():
    cfg = small_config(retrieval={"icp_max_iterations": 3, "top_k": 3},
                       deployment={"warmup": False, "fused_encode": True,
                                   "fused_query": True})
    return NeuralSpectralCodecPipeline(cfg, device="cpu")


def test_warmup_leaves_the_database_and_builds_every_bucket():
    """``warmup()`` with one-dispatch serving builds the serving
    executables (query on and off) at every bucket from 8 up to one beyond
    its replayed session's largest by scratch executions: ``database_size`` and the bytes
    of every row and position are unchanged. A session afterwards builds
    no executable (the CPU's counterpart of no capture mid-stream) and
    counts one step a keyframe."""
    serving.clear_cache()
    pipe = _one_dispatch_pipe()
    ret = pipe.retrieval.retriever
    rng = np.random.default_rng(0)
    ret.add_to_database(rng.random((5, DIM)).astype(np.float32),
                        rng.normal(size=(5, 3)).astype(np.float32))
    rows, pos = ret._db_rows.clone(), ret._db_pos.clone()
    pipe.warmup()
    assert ret.database_size == 5
    assert torch.equal(ret._db_rows, rows) and torch.equal(ret._db_pos, pos)
    mine = [e for e in serving.cached_executables()
            if e._retriever is not None and e._retriever() is ret]
    buckets = sorted({e.shape.n_nodes for e in mine})
    # every bucket from 8 up to one beyond the replay's largest, those the
    # replay skipped included
    assert len(buckets) >= 3 and buckets == [8 << i
                                            for i in range(len(buckets))]
    assert len(mine) == 2 * len(buckets)
    n_built = len(serving.cached_executables())
    eager0 = serving.STATS["eager_steps"]
    from neural_spectral_codec_torch.data.synthetic import SyntheticLoader
    pipe.run_online(SyntheticLoader(n_frames=40, seed=0, n_points=4096,
                                    loops=2.0), loop_closure_interval=10)
    assert len(serving.cached_executables()) == n_built
    n_kf = len(pipe.selector.keyframes)
    assert n_kf > 10 and serving.STATS["eager_steps"] - eager0 == n_kf
    assert pipe.profiler.events["midstream_captures"] == 0


def test_warm_execution_refused_at_a_full_database():
    """A scratch execution needs a free row: at a full database the warm-up
    of the serving step raises, as JAX's ``fused_dispatch(insert=False)``
    does, and leaves the rows as they were; a step that writes no row
    (``serve_step(do_insert=False)``) still runs there."""
    net = SpectralGNN(input_dim=DIM, hidden_dim=32, output_dim=DIM,
                      generator=torch.Generator().manual_seed(1)).eval()
    enc = SpectralEncoderConfig(**ENC)
    rng = np.random.default_rng(4)
    retrieval = TwoStageRetrieval(n_bins=DIM, capacity=6, top_k=3,
                                  device="cpu")
    ret = retrieval.retriever
    ret.add_to_database(rng.random((6, DIM)).astype(np.float32))
    rows = ret._db_rows.clone()
    mgr = TemporalGraphManager(max_active_nodes=100, feature_dim=DIM)
    poses = loop_trajectory(4)
    for i in range(4):
        node = mgr.add_keyframe(Keyframe(i, i, None, poses[i], float(i),
                                         descriptor=np.full(DIM, 1 / DIM,
                                                            np.float32)))
    local = LocalUpdateGNN(net, k_hops=3)
    pts = pad_points(_scan(rng, enc), 1024)
    with pytest.raises(ValueError, match="scratch row"):
        local.warm_serve(mgr, node, pts, 2.0, enc, retrieval)
    g = _graph(rng, 8)
    with pytest.raises(ValueError, match="scratch row"):
        serving.warm_serve_step(ret, net, pts, 2.0, g, 0, 3, config=enc)
    assert torch.equal(ret._db_rows, rows) and ret.database_size == 6
    desc, emb, idx, dist = serving.serve_step(
        ret, net, pts, 2.0, g, 0, np.zeros(4, np.float32), 3,
        do_insert=False, config=enc)
    assert idx.shape == (3,) and ret.database_size == 6
    assert torch.equal(ret._db_rows, rows)


def test_executable_cache_keys():
    """A second bucket, flag or scan shape adds an entry, a repeated key
    returns the same executable, another model gets its own, and
    replacing the database buffers (``clear_database``) drops every entry
    on the old buffers (either model's) and builds anew; the fused encode
    step, which reads no database, stays."""
    serving.clear_cache()
    enc = SpectralEncoderConfig(**ENC)
    net = SpectralGNN(input_dim=DIM, hidden_dim=32, output_dim=DIM).eval()
    ret = WassersteinRetriever(n_bins=DIM, capacity=8, device="cpu")

    def shape(bucket, do_query=True, points=(1024, 4)):
        return serving.step_shape(points, bucket, 6, 2, enc, 2.0, top_k=3,
                                  do_query=do_query, do_insert=True)

    a = serving.executable(net, ret, shape(8), CPU)
    assert serving.executable(net, ret, shape(8), CPU) is a
    assert len(serving.cached_executables()) == 1
    b = serving.executable(net, ret, shape(16), CPU)
    c = serving.executable(net, ret, shape(8, do_query=False), CPU)
    d = serving.executable(net, ret, shape(8, points=(2048, 4)), CPU)
    assert len({id(a), id(b), id(c), id(d)}) == 4
    assert len(serving.cached_executables()) == 4
    other = SpectralGNN(input_dim=DIM, hidden_dim=32, output_dim=DIM).eval()
    e = serving.executable(other, ret, shape(8), CPU)
    assert e is not a and len(serving.cached_executables()) == 5
    enc_only = serving.executable(net, None, shape(8), CPU)
    assert serving.executable(net, None, shape(8), CPU) is enc_only
    ret.clear_database()
    a2 = serving.executable(net, ret, shape(8), CPU)
    assert a2 is not a
    left = serving.cached_executables()
    assert all(x not in left for x in (a, b, c, d, e))
    assert a2 in left and enc_only in left and len(left) == 2
    with pytest.raises(ValueError, match="eval"):
        serving.executable(net.train(), ret, shape(8), CPU)


def test_unpadded_scans_staged_as_pad_points():
    """A host cloud of any size staged into a general-path executable
    equals its ``pad_points`` copy (cut to the executable's rows, intensity
    0 for xyz clouds, NaN rows after), also after a larger scan left more
    rows behind; the step's outputs equal those of the padded scan."""
    net = SpectralGNN(input_dim=DIM, hidden_dim=32, output_dim=DIM,
                      generator=torch.Generator().manual_seed(2)).eval()
    enc = SpectralEncoderConfig(**ENC)
    rng = np.random.default_rng(9)
    g = _graph(rng, 6)
    shape = serving.step_shape((1024, 4), 8, g.max_degree, 2, enc, 2.0)
    exe = serving.executable(net, None, shape, CPU)
    ref = serving.executable(net, None, shape._replace(n_nodes=16), CPU)
    for n, c in ((900, 4), (300, 3), (1500, 4), (20, 3)):
        cloud = rng.normal(0, 20, (n, c)).astype(np.float32)
        exe.stage(cloud, g, 1)
        padded = pad_points(cloud, 1024)
        np.testing.assert_array_equal(exe.inputs.np["points"], padded)
        got = {k: v.copy() for k, v in exe.execute().items()}
        ref.stage(padded, g, 1)
        want = ref.execute()
        np.testing.assert_array_equal(got["desc"], want["desc"])
        np.testing.assert_array_equal(got["emb"], want["emb"][:8])
    with pytest.raises(ValueError, match="points"):
        exe.stage(np.zeros((10, 5), np.float32), g, 1)
