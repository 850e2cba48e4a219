"""PyTorch port vs the JAX reference: the online graph manager
(``TemporalGraphManager``) on one event script and the k-hop local GNN
refresh (``LocalUpdateGNN``: forward_local, the core write-back,
encode_update_local and the one-dispatch serve_step) with the JAX
weights loaded through ``from_flax``."""

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
from neural_spectral_codec_tpu.data.synthetic import (  # noqa: E402
    loop_trajectory)
from neural_spectral_codec_tpu.keyframe.graph import (  # noqa: E402
    TemporalGraphManager as JaxManager)
from neural_spectral_codec_tpu.keyframe.selector import (  # noqa: E402
    Keyframe as JaxKeyframe)
from neural_spectral_codec_tpu.models.gnn import (  # noqa: E402
    LocalUpdateGNN as JaxLocal, SpectralGNN as JaxGNN, init_gnn)
from neural_spectral_codec_tpu.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig as JaxEncConfig)
from neural_spectral_codec_tpu.retrieval.two_stage import (  # noqa: E402
    TwoStageRetrieval as JaxTwoStage)
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: E402
    TemporalGraphManager)
from neural_spectral_codec_torch.keyframe.selector import Keyframe  # noqa: E402
from neural_spectral_codec_torch.models import (  # noqa: E402
    LocalUpdateGNN, SpectralGNN, from_flax)
from neural_spectral_codec_torch.ops.range_image import pad_points  # noqa: E402
from neural_spectral_codec_torch.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig)
from neural_spectral_codec_torch.retrieval.two_stage import (  # noqa: E402
    TwoStageRetrieval)

torch.set_num_threads(2)

EMB_TOL = 1e-5          # embeddings, port vs JAX (float32 GNN)
DESC_TOL = 1e-6         # descriptors on nudged points
ENC = dict(n_elevation=16, n_azimuth=90, n_bins=20, target_elevation_bins=8)
DIM = 160


def _kf_pair(i, desc, pose, points=None):
    return (Keyframe(i, i, points, pose, float(i), descriptor=desc.copy()),
            JaxKeyframe(i, i, points, pose, float(i), descriptor=desc.copy()))


def _assert_graphs_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _run_script(window, n_add, loops, check):
    """Drive both managers through adds, loop edges (some endpoints full
    or frozen) and freezes; ``check`` runs after every event."""
    rng = np.random.default_rng(window)
    poses = loop_trajectory(n_add, radius=60.0, loops=2.0)
    t, j = (TemporalGraphManager(max_active_nodes=window, feature_dim=8),
            JaxManager(max_active_nodes=window, feature_dim=8))
    for i in range(n_add):
        a, b = _kf_pair(i, rng.normal(size=8).astype(np.float32), poses[i])
        assert t.add_keyframe(a) == j.add_keyframe(b)
        for q, m in loops.get(i, ()):
            assert t.add_loop_closure_edge(q, m) == \
                j.add_loop_closure_edge(q, m)
        check(t, j, i)
    return t, j


def test_graph_manager_event_script_equals_jax():
    """Adds, loop edges up to and past the 4 loop slots of a node (the
    free-slot rule; a dropped edge stays dropped), freezes of a 12-node
    window and compaction of the backing buffers past 64 rows: the
    window graph arrays, the k-hop sets and the local subgraphs with their
    mappings equal JAX's after every event."""
    loops = {20: [(20, 10), (20, 11), (20, 12)], 21: [(21, 10), (21, 10)],
             22: [(22, 10), (22, 10), (22, 3)], 40: [(40, 30), (40, 29)],
             70: [(70, 60), (70, 61), (70, 40)], 150: [(150, 140)]}

    def check(t, j, i):
        gt, gj = t.get_graph(), j.get_graph()
        _assert_graphs_equal(gt, gj)
        assert t.get_statistics() == j.get_statistics()
        assert t.keyframe_id_to_node_idx == j.keyframe_id_to_node_idx
        assert t._buf_base == j._buf_base
        n = gt.n_nodes
        for node in {0, n // 2, n - 1}:
            for k in (0, 1, 3):
                assert t.get_k_hop_neighbors(node, k) == \
                    j.get_k_hop_neighbors(node, k)
            (st, mt), (sj, mj) = (t.get_local_subgraph(node, 3),
                                  j.get_local_subgraph(node, 3))
            assert mt == mj
            _assert_graphs_equal(st, sj)

    t, j = _run_script(12, 160, loops, check)
    assert len(t.frozen_keyframes) == 148 and t._buf_base > 64
    assert t.get_node_index(159) == j.get_node_index(159) == 11
    assert t.get_node_index(3) is None
    assert not t.add_loop_closure_edge(159, 3)       # frozen endpoint
    t.set_node_features(5, np.ones(8, np.float32))
    j.set_node_features(5, np.ones(8, np.float32))
    _assert_graphs_equal(t.get_graph(), j.get_graph())
    emb = np.arange(12 * 8, dtype=np.float32).reshape(12, 8)
    t.update_embeddings(emb)
    j.update_embeddings(emb)
    with pytest.raises(ValueError, match="count"):
        t.update_embeddings(emb[:3])
    np.testing.assert_array_equal(t.get_all_descriptors(),
                                  j.get_all_descriptors())
    t.reset()
    assert t.get_graph() is None and t.get_statistics()["total_nodes"] == 0


def test_graph_manager_without_freezing_equals_jax():
    """``freeze_old_embeddings=False`` never freezes: the window grows
    past the configured size, and the frozen embeddings stay None."""
    t = TemporalGraphManager(max_active_nodes=5,
                             freeze_old_embeddings=False, feature_dim=4)
    j = JaxManager(max_active_nodes=5, freeze_old_embeddings=False,
                   feature_dim=4)
    poses = loop_trajectory(80)
    for i in range(80):
        a, b = _kf_pair(i, np.full(4, i, np.float32), poses[i])
        t.add_keyframe(a)
        j.add_keyframe(b)
    _assert_graphs_equal(t.get_graph(), j.get_graph())
    assert len(t.keyframes) == 80 and t.frozen_embeddings is None


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


def _filled_managers(n, loops=()):
    rng = np.random.default_rng(5)
    poses = loop_trajectory(n, radius=40.0)
    t, j = (TemporalGraphManager(max_active_nodes=100, feature_dim=DIM),
            JaxManager(max_active_nodes=100, feature_dim=DIM))
    for i in range(n):
        a, b = _kf_pair(i, rng.random(DIM).astype(np.float32), poses[i])
        t.add_keyframe(a)
        j.add_keyframe(b)
    for q, m in loops:
        t.add_loop_closure_edge(q, m)
        j.add_loop_closure_edge(q, m)
    return t, j


@pytest.mark.parametrize("k_hops", [3, 5])
def test_local_refresh_equals_jax(k_hops):
    """forward_local and update_embeddings_local on a graph with loop
    edges: the center's embedding and the written-back (k − 3)-hop core
    equal JAX's to 1e-5 and the full-graph forward's; at k = 5 the core
    holds more than the center."""
    jmodel, params, stats, net = _models()
    t, j = _filled_managers(30, loops=[(25, 5), (20, 2)])
    tl, jl = LocalUpdateGNN(net, k_hops=k_hops), JaxLocal(
        jmodel, params, stats, k_hops=k_hops)
    full = tl.forward_full(t.get_graph()).numpy()
    for center in (3, 15, 25):
        got = tl.forward_local(t, center).numpy()
        np.testing.assert_allclose(got, np.asarray(jl.forward_local(
            j, center)), rtol=0, atol=EMB_TOL)
        np.testing.assert_allclose(got[0], full[center], rtol=0,
                                   atol=EMB_TOL)
        core_t = tl.update_embeddings_local(t, center)
        core_j = jl.update_embeddings_local(j, center)
        assert core_t == core_j
        assert (len(core_t) > 1) == (k_hops == 5)
        for node in core_t:
            np.testing.assert_allclose(t.keyframes[node].embedding,
                                       j.keyframes[node].embedding, rtol=0,
                                       atol=EMB_TOL)
    assert LocalUpdateGNN._padded(t.get_local_subgraph(3, 1)[0]).n_nodes == 8
    with pytest.raises(ValueError, match="eval"):
        LocalUpdateGNN(SpectralGNN(input_dim=DIM, hidden_dim=32,
                                   output_dim=DIM))


def _scan(rng, proj):
    n = 600
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(np.deg2rad(-24.0), np.deg2rad(1.0), n)
    r = rng.uniform(2.0, 60.0, n)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el), np.zeros(n)], 1).astype(np.float32)
    return nudge_points(pts, proj)


@pytest.mark.parametrize("metric,storage", [("wasserstein", "float32"),
                                            ("wasserstein", "uint16"),
                                            ("l2", "float32")])
def test_serving_session_equals_jax(metric, storage):
    """25 keyframes: the port's one-dispatch serve_step (query every 5th,
    before the insert) against JAX's, and the port's encode_update_local
    chain (insert, then query with exclude_last = context_window)
    against the port's serve_step: descriptors <= 1e-6 (nudged points),
    refreshed embeddings <= 1e-5, database rows <= 1e-6, positions equal,
    top-k indices equal, distances rtol 2e-5. uint16 codes may differ by
    one where a CDF value lies within a float32 rounding of a code
    midpoint (the two frameworks' CDFs differ by ~1e-7), so there rows
    are held to one code and distances to 4 codes (4/65535)."""
    jmodel, params, stats, net = _models(1)
    jenc = JaxEncConfig(use_pallas=False, **ENC)
    enc = SpectralEncoderConfig(**ENC)
    rng = np.random.default_rng(3)
    poses = loop_trajectory(25)
    scans = [_scan(rng, enc.projection) for _ in range(25)]
    kw = dict(top_k=3, spatial_filter_distance=0.0, context_window=5,
              n_bins=DIM, capacity=64, stage1_metric=metric,
              stage1_storage=storage)
    runs = {}
    for name in ("jax", "serve", "split"):
        mgr = (JaxManager if name == "jax" else TemporalGraphManager)(
            max_active_nodes=100, feature_dim=DIM)
        if name == "jax":
            ret = JaxTwoStage(verification_backend="jax", **kw)
            local = JaxLocal(jmodel, params, stats, k_hops=3)
        else:
            ret = TwoStageRetrieval(verification_backend="torch",
                                    device="cpu", **kw)
            local = LocalUpdateGNN(net, k_hops=3)
        kcls = JaxKeyframe if name == "jax" else Keyframe
        descs, stage1s = [], []
        for i in range(25):
            do_query = (i + 1) % 5 == 0
            kf = kcls(i, i, scans[i], poses[i], float(i),
                      descriptor=np.zeros(DIM, np.float32))
            node = mgr.add_keyframe(kf)
            pts = pad_points(scans[i], 1024)
            if name == "split":
                desc, _ = local.encode_update_local(mgr, node, pts, 2.0, enc)
                kf.descriptor = desc
                ret.add_keyframe(kf)
                if do_query:
                    vec = kf.embedding if metric == "l2" else kf.descriptor
                    stage1s.append(ret.retriever.query(
                        vec, top_k=3, exclude_last=ret.context_window))
            else:
                desc, core, s1 = local.serve_step(
                    mgr, node, jnp.asarray(pts) if name == "jax" else pts,
                    jnp.float32(2.0) if name == "jax" else 2.0,
                    jenc if name == "jax" else enc, ret, do_query,
                    query_pose_position=poses[i][:3, 3])
                assert core == [node]
                kf.descriptor = desc
                ret.register_fused_insert(kf)
                if do_query:
                    stage1s.append(s1)
            descs.append(np.asarray(desc))
        r = ret.retriever
        n = r.database_size
        rows = (np.asarray(r._db_cdf[:n]) if name == "jax"
                else r._db_rows[:n].view(torch.int16).numpy().view(np.uint16)
                if storage == "uint16" else r._db_rows[:n].numpy())
        pos = np.asarray(r._db_pos[:n]) if name == "jax" \
            else r._db_pos[:n].numpy()
        embs = np.stack([k.embedding for k in mgr.keyframes])
        runs[name] = (np.stack(descs), rows, pos, stage1s, embs)
    want = runs["jax"]
    for name in ("serve", "split"):
        d, rows, pos, s1, embs = runs[name]
        np.testing.assert_allclose(d, want[0], rtol=0, atol=DESC_TOL)
        np.testing.assert_allclose(embs, want[4], rtol=0, atol=EMB_TOL)
        if storage == "uint16":
            assert np.abs(rows.astype(np.int64) - want[1]).max() <= 1
        else:
            np.testing.assert_allclose(rows, want[1], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(pos, want[2])
        assert len(s1) == 5
        atol = 4 / 65535 if storage == "uint16" else 1e-5
        for (gi, gd), (wi, wd) in zip(s1, want[3]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gd, wd, rtol=2e-5, atol=atol)
