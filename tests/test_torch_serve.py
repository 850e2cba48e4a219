"""PyTorch port vs the JAX reference: the W₁ retriever, the serving step
(encode → feature write → GNN → query → insert), the device helper, and
the rule that the port never imports jax."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_encode import nudge_points  # noqa: E402
from neural_spectral_codec_tpu.models.gnn import (  # noqa: E402
    SpectralGNN as JaxGNN, _jitted_serving_step, init_gnn)
from neural_spectral_codec_tpu.ops.ring_path import (  # noqa: E402
    make_structured_ring_scans)
from neural_spectral_codec_tpu.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig as JaxEncConfig)
from neural_spectral_codec_tpu.ops.wasserstein import (  # noqa: E402
    histogram_cdf as jax_histogram_cdf)
from neural_spectral_codec_tpu.retrieval.retriever import (  # noqa: E402
    _query_batch_kernel, _query_kernel)
from neural_spectral_codec_torch import resolve_device  # noqa: E402
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: E402
    build_graph, graph_to_tensors)
from neural_spectral_codec_torch.models import (  # noqa: E402
    SpectralGNN, from_flax, serve_step)
from neural_spectral_codec_torch.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig)
from neural_spectral_codec_torch.retrieval import (  # noqa: E402
    WassersteinRetriever)

torch.set_num_threads(2)


def _hists(rng, n, width=800):
    h = rng.random((n, width)).astype(np.float32) ** 4
    return h / h.sum(axis=1, keepdims=True)


def _jax_db(rows, pos, capacity, metric):
    """JAX-side database buffers as the JAX retriever stores them."""
    rows = jnp.asarray(rows)
    if metric == "wasserstein":
        rows = jax_histogram_cdf(rows)
    db = jnp.zeros((capacity, rows.shape[1]), jnp.float32).at[
        :rows.shape[0]].set(rows)
    db_pos = jnp.zeros((capacity, 3), jnp.float32).at[:pos.shape[0]].set(
        jnp.asarray(pos))
    return db, db_pos


@pytest.mark.parametrize("metric", ["wasserstein", "l2"])
def test_query_matches_jax(metric):
    """Single and batched queries with the size mask (exclude_last) and
    the spatial filter: equal indices; distances to rtol 2e-5. A W₁
    distance is a float32 sum of 800 |CDF differences| after an 800-long
    cumsum, and XLA and PyTorch accumulate both in other orders (bound
    800 · 2⁻²⁴ ≈ 4.8e-5 relative; about 3e-6 observed at distances ~5)."""
    rng = np.random.default_rng(0)
    n, cap, k = 60, 80, 7
    hists = _hists(rng, n)
    pos = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    ret = WassersteinRetriever(capacity=cap, metric=metric, device="cpu")
    ret.add_to_database(hists[:20], pos[:20])
    ret.add_to_database(torch.from_numpy(hists[20:]), torch.from_numpy(pos[20:]))
    db, db_pos = _jax_db(hists, pos, cap, metric)
    queries = hists[[3, 41, 59]] + _hists(rng, 3) * 0.3
    qpos = pos[[3, 41, 59]] + 1.0
    for i, (q, p) in enumerate(zip(queries, qpos)):
        min_d = 0.0 if i == 0 else 12.0
        qp = np.array([*p, min_d], np.float32)
        want_i, want_d = _query_kernel(db, db_pos, jnp.int32(n - 5),
                                       jnp.asarray(q), jnp.asarray(qp), k,
                                       metric)
        want_d = np.asarray(want_d)
        keep = np.isfinite(want_d)
        got_i, got_d = ret.query(q, k, query_position=p,
                                 spatial_min_distance=min_d, exclude_last=5)
        np.testing.assert_array_equal(got_i, np.asarray(want_i)[keep])
        np.testing.assert_allclose(got_d, want_d[keep], rtol=2e-5, atol=1e-6)
    qp = np.concatenate([qpos, np.full((3, 1), 12.0, np.float32)], axis=1)
    want_i, want_d = _query_batch_kernel(db, db_pos, jnp.int32(n - 5),
                                         jnp.asarray(queries),
                                         jnp.asarray(qp), k, metric)
    got_i, got_d = ret.query_batch(queries, k, query_positions=qpos,
                                   spatial_min_distance=12.0, exclude_last=5)
    want_d = np.asarray(want_d)
    np.testing.assert_array_equal(
        got_i, np.where(np.isfinite(want_d), np.asarray(want_i), -1))
    np.testing.assert_allclose(got_d, want_d, rtol=2e-5, atol=1e-6)


def test_query_masks_and_capacity():
    rng = np.random.default_rng(1)
    ret = WassersteinRetriever(capacity=8, device="cpu")
    assert ret.query(_hists(rng, 1)[0])[0].size == 0
    hists = _hists(rng, 8)
    ret.add_to_database(hists, np.zeros((8, 3), np.float32))
    with pytest.raises(ValueError, match="capacity"):
        ret.add_to_database(hists[:1])
    # k larger than the valid rows: only finite entries come back
    idx, dist = ret.query(hists[2], top_k=20, exclude_last=5)
    assert list(idx[:1]) == [2] and len(idx) == 3 and dist[0] < 1e-6
    # every row inside the spatial filter: nothing comes back
    idx, _ = ret.query(hists[2], query_position=np.zeros(3),
                       spatial_min_distance=1.0)
    assert idx.size == 0
    bi, bd = ret.query_batch(hists[:2], top_k=10, exclude_last=6)
    assert bi.shape == (2, 8) and (bi[:, 2:] == -1).all()
    assert np.isinf(bd[:, 2:]).all()


def _serving_setup(seed=0):
    rng = np.random.default_rng(seed)
    n_nodes = 12
    poses = np.tile(np.eye(4), (n_nodes, 1, 1))
    poses[:, 0, 3] = np.arange(n_nodes) * 3.0
    graph = build_graph(_hists(rng, n_nodes), poses,
                        loop_closures=[(1, 10), (2, 9)])
    jmodel = JaxGNN()
    params, stats = init_gnn(jmodel, jax.random.key(seed))
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a), stats)
    for bn in stats.values():
        bn["mean"] = rng.normal(0, 0.05, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    net = SpectralGNN()
    net.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params),
                                  stats))
    return rng, graph, jmodel, params, stats, net.eval()


def test_serve_step_matches_jax():
    """Two requests through ``serve_step`` and through the JAX one-dispatch
    ``_jitted_serving_step``: an arbitrary-order scan (general path) and a
    ring-structured scan (ring path; JAX runs the general path on the same
    points, equal for contract-satisfying input). Descriptors <= 1e-6 on
    nudged input, embeddings <= 1e-5, equal top-k indices, distances to
    rtol 2e-5 (see test_query_matches_jax), inserted rows <= 1e-6."""
    rng, graph, jmodel, params, stats, net = _serving_setup()
    cfg = SpectralEncoderConfig()
    jcfg = JaxEncConfig(use_pallas=False)
    cap, n0, k, window = 40, 25, 5, 3
    hists = _hists(rng, n0)
    pos = rng.uniform(-50, 50, (n0, 3)).astype(np.float32)
    ret = WassersteinRetriever(capacity=cap, device="cpu")
    ret.add_to_database(hists, pos)
    db, db_pos = _jax_db(hists, pos, cap, "wasserstein")
    from conftest import synthetic_scan
    general = nudge_points(synthetic_scan(rng, 4096), jcfg.projection)
    ring = nudge_points(make_structured_ring_scans(1, 64, 64,
                                                   jcfg.projection,
                                                   seed=3)[0],
                        jcfg.projection)
    tgraph = graph_to_tensors(graph, "cpu")
    features = jnp.asarray(graph.features)
    step = _jitted_serving_step(jmodel, jcfg, k, "wasserstein", "float32",
                                1e-8, True, True)
    for i, (pts, center) in enumerate(((general, 4), (ring, 7))):
        qp = np.array([*pos[5 + i], 10.0], np.float32)
        size = ret.database_size
        db, db_pos, jdesc, jemb, jidx, jdist = step(
            db, db_pos, jnp.asarray(pts.reshape(-1, 4)), jnp.float32(2.0),
            params, stats, features, jnp.asarray(graph.neighbors),
            jnp.asarray(graph.mask), jnp.asarray(graph.edge_feats),
            jnp.int32(center), jnp.int32(size), jnp.int32(size - window + 1),
            jnp.asarray(qp), jnp.asarray(qp[:3]))
        features = features.at[center].set(jdesc)
        desc, emb, idx, dist = serve_step(
            ret, net, torch.from_numpy(pts), 2.0, tgraph, center,
            torch.from_numpy(qp), k, config=cfg,
            row_of_ring=tuple(range(64)) if pts.ndim == 3 else None,
            context_window=window)
        np.testing.assert_allclose(desc.numpy(), np.asarray(jdesc), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(dist.numpy(), np.asarray(jdist),
                                   rtol=2e-5, atol=1e-6)
        assert np.isinf(dist.numpy()).sum() == np.isinf(np.asarray(jdist)).sum()
        assert ret.database_size == size + 1
        np.testing.assert_allclose(ret._db_rows[size].numpy(),
                                   np.asarray(db[size]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ret._db_pos[size].numpy(), qp[:3])
        assert torch.equal(tgraph.features[center], desc)


def test_serve_step_without_query_or_insert():
    rng, graph, _, _, _, net = _serving_setup(1)
    ret = WassersteinRetriever(capacity=4, device="cpu")
    tgraph = graph_to_tensors(graph, "cpu")
    pts = torch.from_numpy(rng.normal(0, 20, (2048, 4)).astype(np.float32))
    desc, emb, idx, dist = serve_step(ret, net, pts, 2.0, tgraph, 0,
                                      torch.zeros(4), 3, do_query=False,
                                      do_insert=False)
    assert idx is None and dist is None and ret.database_size == 0
    assert desc.shape == (800,) and emb.shape == (12, 800)
    with pytest.raises(ValueError, match="row_of_ring"):
        serve_step(ret, net, pts.reshape(32, 64, 4), 2.0, tgraph, 0,
                   torch.zeros(4), 3)
    with pytest.raises(ValueError, match="eval"):
        serve_step(ret, net.train(), pts, 2.0, tgraph, 0, torch.zeros(4), 3)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    else:
        with pytest.raises(RuntimeError, match="no CUDA"):
            resolve_device("cuda")


NEW_MODULES = ("ops.probe_kernels", "utils.timing",
               "experiments.ring_stage_probe", "experiments.profile_hotpath",
               "training.loss", "training.miner", "training.validation",
               "training.trainer", "data.pose_utils", "data.synthetic",
               "keyframe.criteria", "keyframe.selector", "utils.config",
               "pipeline", "train_multi_dataset", "experiments.scale_100k",
               "ops.quantization", "retrieval.g2o", "retrieval.verification",
               "retrieval.two_stage", "utils.profiler", "native.geom",
               "experiments.online_latency", "data.kitti", "data.nclt",
               "data.helipr", "data.multi_dataset", "data.native_io",
               "native.io", "evaluation", "benchmark_cli",
               "utils.logging_setup", "parallel.mesh", "parallel.encode",
               "parallel.retrieval", "parallel.train", "parallel.dryrun",
               "retrieval.pca_kernel",
               "experiments.kernel_ab", "experiments.parallel_profile",
               "entry", "native", "experiments.retrieval_latency",
               "experiments.degraded_recall",
               "experiments.cross_sensor_uplift",
               "experiments.density_defense",
               "experiments.selection_divergence")


def test_port_imports_without_jax():
    """The port, every module of it (the probe kernels, the timing helper,
    the measurement entry points, the training modules, the pipeline, the
    training entry point and the online loop's modules included), and
    chip_smoke.py import torch
    and numpy but never jax, flax, optax or orbax (a fresh interpreter,
    so nothing is preloaded)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import neural_spectral_codec_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    assert p.__name__ + '.' + m in sys.modules, m\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'orbax',"
        " 'neural_spectral_codec_tpu')))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) >= 47
