"""PyTorch port vs the JAX reference: the multi-device layer
(``neural_spectral_codec_torch/parallel/``), case for case with
``tests/test_parallel.py``.

Each port function runs on ``Mesh([cpu] * 8)`` (eight logical shards on
the CPU, the counterpart of the 8 virtual XLA CPU devices that
``conftest.py`` gives JAX) and is held against two references on the same
numpy input: the port's single-device function, and the JAX sharded
function on the 8-device CPU mesh. Tolerances are the JAX file's unless a
case states another. Small shapes throughout."""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from neural_spectral_codec_tpu import parallel as jpar  # noqa: E402
from neural_spectral_codec_tpu.keyframe.graph import (  # noqa: E402
    build_graph)
from neural_spectral_codec_tpu.models.gnn import (  # noqa: E402
    SpectralGNN as JaxGNN, init_gnn)
from neural_spectral_codec_tpu.ops import ring_path as jrp  # noqa: E402
from neural_spectral_codec_tpu.ops import spectral as jspec  # noqa: E402
from neural_spectral_codec_tpu.parallel.train import (  # noqa: E402
    make_sharded_eval_step as jax_eval_step)
from neural_spectral_codec_tpu.retrieval.retriever import (  # noqa: E402
    WassersteinRetriever as JaxRetriever)
from neural_spectral_codec_tpu.training import loss as jloss  # noqa: E402
from neural_spectral_codec_tpu.training import (  # noqa: E402
    trainer as jtrainer)
from neural_spectral_codec_tpu.training import (  # noqa: E402
    validation as jval)
from neural_spectral_codec_torch import parallel as tpar  # noqa: E402
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: E402
    graph_to_tensors)
from neural_spectral_codec_torch.models import (  # noqa: E402
    SpectralGNN, from_flax)
from neural_spectral_codec_torch.models.gnn import (  # noqa: E402
    gnn_forward)
from neural_spectral_codec_torch.ops import ring_path as trp  # noqa: E402
from neural_spectral_codec_torch.ops import spectral as tspec  # noqa: E402
from neural_spectral_codec_torch.parallel import mesh as tmesh  # noqa: E402
from neural_spectral_codec_torch.parallel.encode import (  # noqa: E402
    make_sharded_ring_encoder)
from neural_spectral_codec_torch.parallel.train import (  # noqa: E402
    make_sharded_eval_step, place_graph)
from neural_spectral_codec_torch.retrieval.retriever import (  # noqa: E402
    WassersteinRetriever)
from neural_spectral_codec_torch.training import (  # noqa: E402
    validation as tval)
from neural_spectral_codec_torch.training.trainer import (  # noqa: E402
    GNNTrainer, make_optimizer, train_step)
from tests.conftest import synthetic_scan  # noqa: E402
from test_torch_encode import nudge_points  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _mesh8():
    return tpar.Mesh([CPU] * 8)


def _tiny_graph(rng, n_nodes=16, dim=32):
    poses = np.tile(np.eye(4, dtype=np.float32), (n_nodes, 1, 1))
    poses[:, 0, 3] = np.arange(n_nodes, dtype=np.float32) * 2.0
    feats = rng.random((n_nodes, dim), dtype=np.float32)
    return build_graph(feats, poses)


def _small_models(seed=0):
    """The JAX model, its init_gnn params and the port model holding
    them (train mode, dropout 0), at test_parallel.py's widths."""
    jm = JaxGNN(input_dim=32, hidden_dim=16, output_dim=32, dropout=0.0)
    params, bs = init_gnn(jm, jax.random.key(seed))
    tm = SpectralGNN(input_dim=32, hidden_dim=16, output_dim=32,
                     dropout=0.0)
    tm.load_state_dict(from_flax(params, bs))
    return jm, params, bs, tm


def _grads_close(got, want, rel=1e-5):
    """test_parallel.py's bar (``rel`` 1e-5): reassociation noise scales
    with the leaf's gradient; leaves whose true gradient is 0 sit under
    the atol floor."""
    for k, b in want.items():
        a = got[k]
        np.testing.assert_allclose(a, b, atol=3e-5 + rel * np.abs(b).max(),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def test_mesh_creation(monkeypatch):
    """A mesh of 8 logical CPU shards has an 8-wide data axis, as JAX's
    create_mesh(8) does; create_mesh refuses more devices than exist and
    takes the first n of those there are."""
    assert _mesh8().shape["data"] == 8 == jpar.create_mesh(8).shape["data"]
    assert tpar.create_mesh(device="cpu").devices == (CPU,)
    with pytest.raises(ValueError, match="only 1 present"):
        tpar.create_mesh(2, device="cpu")
    monkeypatch.setattr(tmesh, "devices_of", lambda t: [CPU] * 4)
    assert tpar.create_mesh(3, device="cpu").shape == {"data": 3}
    a = np.arange(16.0).reshape(8, 2)
    slabs = tpar.shard_array(a, _mesh8())
    assert [s.tolist() for s in slabs] == [[r.tolist()] for r in a]
    with pytest.raises(ValueError, match="not divisible"):
        tpar.shard_array(np.zeros(10), _mesh8())
    reps = tpar.replicate({"w": torch.ones(2)}, tpar.Mesh([CPU] * 3))
    assert len(reps) == 3 and all(torch.equal(r["w"], torch.ones(2))
                                  for r in reps)


# ---------------------------------------------------------------------------
# sharded encoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("elevation_mode", ["clip", "drop"])
def test_sharded_encoder_matches_single_device(rng, elevation_mode):
    """8 scans, one a shard: equal to the port's batch encoder run on each
    shard's own slab (the same function at the same batch shape on the
    same tensor, so bit-equal by construction; a batch of 8 need not
    round alike, since the CPU's FFT and product paths may sum in another
    order at another batch size), and within test_parallel.py's bar of
    JAX's sharded encoder on scans nudged off the bin edges (an ulp of
    atan2 between frameworks would move a point's bin)."""
    kw = dict(n_elevation=16, n_azimuth=90, n_bins=20,
              elevation_mode=elevation_mode)
    tcfg, jcfg = tspec.SpectralEncoderConfig(**kw), \
        jspec.SpectralEncoderConfig(**kw)
    pts = np.stack([synthetic_scan(rng, 4000) for _ in range(8)])
    pts = nudge_points(np.nan_to_num(pts), tcfg.projection)
    got = tpar.make_sharded_encoder(tcfg, _mesh8())(
        torch.from_numpy(pts), 2.0).numpy()
    single = torch.cat([
        tspec.encode_points_batch(slab, 2.0, tcfg)
        for slab in tpar.shard_array(torch.from_numpy(pts), _mesh8())
    ]).numpy()
    np.testing.assert_array_equal(got, single)
    want = np.asarray(jpar.make_sharded_encoder(jcfg, jpar.create_mesh(8))(
        jnp.asarray(pts), jnp.float32(2.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sharded_ring_encoder_matches_single_device():
    """The ring path, 8 structured scans (16 rings of 128): equal to the
    port's ring batch encoder, and within 1e-6 of JAX's sharded ring
    encoder on the scans nudged off the bin edges (the port's ring-path
    parity bar, test_torch_ring.py; test_parallel.py's rtol 1e-6 / atol
    1e-7 holds sharded against single-device within one framework, as
    the first check here does)."""
    kw = dict(n_elevation=16, n_azimuth=90, n_bins=20)
    tcfg, jcfg = tspec.SpectralEncoderConfig(**kw), \
        jspec.SpectralEncoderConfig(**kw)
    rows = tuple(range(16))
    pts = nudge_points(jrp.make_structured_ring_scans(
        8, 16, 128, jcfg.projection, seed=3), tcfg.projection)
    got = make_sharded_ring_encoder(tcfg, _mesh8(), rows)(
        torch.from_numpy(pts), 2.0).numpy()
    single = trp.encode_points_ring_batch(torch.from_numpy(pts), 2.0, tcfg,
                                          rows).numpy()
    np.testing.assert_array_equal(got, single)
    want = np.asarray(jpar.encode.make_sharded_ring_encoder(
        jcfg, jpar.create_mesh(8), rows)(jnp.asarray(pts), jnp.float32(2.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# sharded training
# ---------------------------------------------------------------------------

def _jax_sharded_loss_grads(jm, params, bs, graph, tri, shard_nodes):
    """test_parallel.py's sharded value_and_grad on the 8-device mesh."""
    def loss_fn(p, features, neighbors, mask, edge_feats,
                a_idx, p_idx, n_idx, tmask):
        emb, _ = jm.apply(
            {"params": p, "batch_stats": bs},
            features, neighbors, mask, edge_feats, train=True,
            rngs={"dropout": jax.random.key(1)}, mutable=["batch_stats"])
        return jloss.triplet_loss(emb[a_idx], emb[p_idx], emb[n_idx],
                                  margin=0.1, mask=tmask)

    mesh = jpar.create_mesh(8)
    repl = NamedSharding(mesh, P())
    dp = NamedSharding(mesh, P("data"))
    nodes2 = NamedSharding(mesh, P("data", None)) if shard_nodes else repl
    nodes3 = (NamedSharding(mesh, P("data", None, None)) if shard_nodes
              else repl)
    g = (jnp.asarray(graph.features), jnp.asarray(graph.neighbors),
         jnp.asarray(graph.mask), jnp.asarray(graph.edge_feats))
    tr = (jnp.asarray(tri[:, 0]), jnp.asarray(tri[:, 1]),
          jnp.asarray(tri[:, 2]), jnp.asarray(np.ones(len(tri), bool)))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn),
                          in_shardings=(repl, nodes2, nodes2, nodes2, nodes3,
                                        dp, dp, dp, dp))(params, *g, *tr)
    return float(loss), {k: v.numpy() for k, v in from_flax(
        jax.tree.map(np.asarray, grads)).items()}


def _port_loss_grads(tm, graph, tri, mesh, shard_nodes):
    """Loss and raw gradients of one port step (SGD at lr 0, no clip, so
    the parameters stay and ``.grad`` holds the gradients); ``mesh`` None
    runs the single-device ``train_step``."""
    opt = torch.optim.SGD(tm.parameters(), lr=0.0)
    t = torch.from_numpy(tri)
    mask = torch.ones(len(tri), dtype=torch.bool)
    if mesh is None:
        loss = train_step(tm, opt, graph_to_tensors(graph, "cpu"), t[:, 0],
                          t[:, 1], t[:, 2], mask, 0.1, grad_clip=None)
    else:
        step = tpar.make_sharded_train_step(tm, opt, mesh,
                                            shard_nodes=shard_nodes,
                                            grad_clip=None)
        loss = step(place_graph(graph, mesh, shard_nodes), t[:, 0], t[:, 1],
                    t[:, 2], mask, 0.1)
    return float(loss), {k: p.grad.numpy().copy()
                         for k, p in tm.named_parameters()}


@pytest.mark.parametrize("shard_nodes", [False, True])
def test_sharded_grads_match_single_device(rng, shard_nodes):
    """Loss and raw gradients of the port's sharded step (DP replicas, or
    node slabs with global BatchNorm statistics) equal the port's
    single-device step at test_parallel.py's bar (loss rtol 1e-5, atol
    1e-6; gradients atol 3e-5 + 1e-5·max|g|), and JAX's sharded
    value_and_grad at the same loss bar and gradients within
    3e-5 + 2e-5·max|g|: on this input (unnormalised features, so large
    BatchNorm means) the port's single-device gradient is itself up to
    1.3e-5·max|g| from JAX's (gat_layers.0.lin.weight; FlaxBatchNorm1d's
    one-pass variance), which is framework noise, not sharding."""
    jm, params, bs, _ = _small_models()
    graph = _tiny_graph(rng, n_nodes=16, dim=32)
    tri = rng.integers(0, 16, (16, 3))
    j_loss, j_grads = _jax_sharded_loss_grads(jm, params, bs, graph, tri,
                                              shard_nodes)
    l1, g1 = _port_loss_grads(_small_models()[3], graph, tri, None, False)
    l8, g8 = _port_loss_grads(_small_models()[3], graph, tri, _mesh8(),
                              shard_nodes)
    for ref_loss, ref_grads, rel in ((l1, g1, 1e-5),
                                     (j_loss, j_grads, 2e-5)):
        np.testing.assert_allclose(l8, ref_loss, rtol=1e-5, atol=1e-6)
        _grads_close(g8, ref_grads, rel)


@pytest.mark.parametrize("shard_nodes", [False, True])
def test_sharded_train_step_runs_and_learns(rng, shard_nodes):
    """Three Adam steps of the sharded step (clip 1.0) stay in lockstep
    with the port's single-device step and with JAX's sharded step from
    the same parameters: loss rtol 1e-4, atol 1e-5 each step."""
    jm, params, bs, tm8 = _small_models()
    tm1 = _small_models()[3]
    graph = _tiny_graph(rng, n_nodes=16, dim=32)
    tri = rng.integers(0, 16, (16, 3))
    t = torch.from_numpy(tri)
    mask = torch.ones(16, dtype=torch.bool)
    mesh = _mesh8()
    step = tpar.make_sharded_train_step(tm8, make_optimizer(tm8), mesh,
                                        shard_nodes=shard_nodes)
    placed = place_graph(graph, mesh, shard_nodes)
    opt1 = make_optimizer(tm1)
    g1 = graph_to_tensors(graph, "cpu")
    jopt = jtrainer.make_optimizer()
    jstep = jpar.make_sharded_train_step(jm, jopt, jpar.create_mesh(8),
                                         shard_nodes=shard_nodes)
    jstate = (params, bs, jopt.init(params))
    g = (jnp.asarray(graph.features), jnp.asarray(graph.neighbors),
         jnp.asarray(graph.mask), jnp.asarray(graph.edge_feats))
    jtr = (jnp.asarray(tri[:, 0]), jnp.asarray(tri[:, 1]),
           jnp.asarray(tri[:, 2]), jnp.asarray(np.ones(16, bool)))
    for i in range(3):
        got = float(step(placed, t[:, 0], t[:, 1], t[:, 2], mask, 0.1))
        ref = float(train_step(tm1, opt1, g1, t[:, 0], t[:, 1], t[:, 2],
                               mask, 0.1, grad_clip=1.0))
        *jstate, jl = jstep(*jstate, *g, *jtr, 0.1, jax.random.key(i))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, float(jl), rtol=1e-4, atol=1e-5)


def test_sharded_dropout_draws_one_graphs_masks(rng):
    """With dropout on, the node-sharded and the DP step draw the masks
    one graph draws: from one generator state each gives the
    single-device step's loss and gradients (bars as above)."""
    graph = _tiny_graph(rng, n_nodes=16, dim=32)
    tri = rng.integers(0, 16, (16, 3))
    t = torch.from_numpy(tri)
    mask = torch.ones(16, dtype=torch.bool)

    def run(mesh, shard_nodes):
        tm = SpectralGNN(input_dim=32, hidden_dim=16, output_dim=32,
                         dropout=0.3,
                         generator=torch.Generator().manual_seed(0))
        opt = torch.optim.SGD(tm.parameters(), lr=0.0)
        gen = torch.Generator().manual_seed(5)
        if mesh is None:
            loss = train_step(tm, opt, graph_to_tensors(graph, "cpu"),
                              t[:, 0], t[:, 1], t[:, 2], mask, 0.1,
                              grad_clip=None, generator=gen)
        else:
            loss = tpar.make_sharded_train_step(
                tm, opt, mesh, shard_nodes=shard_nodes, grad_clip=None)(
                place_graph(graph, mesh, shard_nodes), t[:, 0], t[:, 1],
                t[:, 2], mask, 0.1, gen)
        return float(loss), {k: p.grad.numpy().copy()
                             for k, p in tm.named_parameters()}, \
            gen.get_state()

    l1, g1, s1 = run(None, False)
    for shard_nodes in (False, True):
        l8, g8, s8 = run(_mesh8(), shard_nodes)
        np.testing.assert_allclose(l8, l1, rtol=1e-5, atol=1e-6)
        _grads_close(g8, g1)
        assert torch.equal(s8, s1), "the generator moved differently"


def test_sharded_eval_matches_single_device(rng):
    """Node-sharded eval forward (24 nodes, 3 a shard): equal to the
    port's gnn_forward and to JAX's sharded eval step within rtol 1e-4,
    atol 1e-5."""
    jm, params, bs, tm = _small_models()
    graph = _tiny_graph(rng, n_nodes=24, dim=32)
    mesh = _mesh8()
    got = make_sharded_eval_step(tm, mesh, shard_nodes=True)(
        place_graph(graph, mesh, True)).numpy()
    tm.eval()
    single = gnn_forward(tm, graph_to_tensors(graph, "cpu")).numpy()
    want = np.asarray(jax_eval_step(jm, jpar.create_mesh(8),
                                    shard_nodes=True)(
        params, bs, jnp.asarray(graph.features),
        jnp.asarray(graph.neighbors), jnp.asarray(graph.mask),
        jnp.asarray(graph.edge_feats)))
    for ref in (single, want):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def _load_flax(trainer, params, bs):
    trainer.model.load_state_dict(from_flax(params, bs))


def test_trainer_sharded_embed_and_validate_match_single_device(rng,
                                                                 tmp_path):
    """GNNTrainer(mesh, shard_nodes) on 21 nodes (not a multiple of 8:
    embed pads): embeddings equal the single-device trainer's and JAX's
    mesh trainer's with the same parameters (rtol 1e-4, atol 1e-5); the
    query-sharded recall and validate() equal the single-device pass and
    JAX's mesh pass (1e-6)."""
    n_nodes, dim = 21, 32
    graph = _tiny_graph(rng, n_nodes=n_nodes, dim=dim)
    model_kw = dict(input_dim=dim, hidden_dim=16, output_dim=dim,
                    dropout=0.0)
    mesh = _mesh8()
    j_mesh = jtrainer.GNNTrainer(model=JaxGNN(**model_kw),
                                 mesh=jpar.create_mesh(8), shard_nodes=True,
                                 seed=0,
                                 checkpoint_dir=str(tmp_path / "j"))
    t_mesh = GNNTrainer(model=SpectralGNN(**model_kw), mesh=mesh,
                        shard_nodes=True, seed=0,
                        checkpoint_dir=str(tmp_path / "m"), device="cpu")
    t_one = GNNTrainer(model=SpectralGNN(**model_kw), seed=0,
                       checkpoint_dir=str(tmp_path / "o"), device="cpu")
    for t in (t_mesh, t_one):
        _load_flax(t, j_mesh.params, j_mesh.batch_stats)
    emb_m, emb_1 = t_mesh.embed(graph), t_one.embed(graph)
    assert emb_m.shape == (n_nodes, dim)
    for ref in (emb_1, j_mesh.embed(graph)):
        np.testing.assert_allclose(emb_m, ref, rtol=1e-4, atol=1e-5)

    period = 10
    poses = np.tile(np.eye(4, dtype=np.float32), (n_nodes, 1, 1))
    ang = np.arange(n_nodes) * 2 * np.pi / period
    poses[:, 0, 3] = 30.0 * np.cos(ang)
    poses[:, 1, 3] = 30.0 * np.sin(ang)
    kw = dict(k=1, distance_threshold=1.0, skip_frames=period - 1)
    r_m, nq_m = tval.recall_loop_closure(emb_1, poses, mesh=mesh, **kw)
    r_1, nq_1 = tval.recall_loop_closure(emb_1, poses, device="cpu", **kw)
    r_j, nq_j = jval.recall_loop_closure(emb_1, poses,
                                         mesh=jpar.create_mesh(8), **kw)
    assert nq_m == nq_1 == nq_j > 0
    assert abs(r_m - r_1) < 1e-6 and abs(r_m - r_j) < 1e-6

    vkw = dict(distance_threshold=1.0, skip_frames=period - 1, ks=(1, 5))
    m, m1, mj = (t.validate(graph, poses, **vkw)
                 for t in (t_mesh, t_one, j_mesh))
    for key in ("recall@1", "recall@5", "n_queries"):
        assert abs(m[key] - m1[key]) < 1e-6, (key, m[key], m1[key])
        assert abs(m[key] - mj[key]) < 1e-6, (key, m[key], mj[key])


def test_pad_to_multiple():
    a = np.arange(10)
    for pad in (tpar.pad_to_multiple, jpar.pad_to_multiple):
        p, m = pad(a, 8)
        assert p.shape[0] == 16 and m.sum() == 10
        b, mb = pad(np.ones((8, 2)), 8)
        assert b.shape == (8, 2) and mb.all()
    for args in ((a, 8), (np.ones((5, 3)), 4, 1, -1.0)):
        got, want = tpar.pad_to_multiple(*args), jpar.pad_to_multiple(*args)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


class _Fixed:
    """A miner that hands out the same triplets to every trainer (JAX's
    and the port's random streams differ)."""

    def __init__(self, triplets):
        self.triplets = triplets

    def mine_triplets(self, **kw):
        return self.triplets


def test_trainer_with_mesh_trains(rng, tmp_path):
    """GNNTrainer(mesh=) trains an epoch of 64-triplet steps data-parallel
    and tracks the single-device trainer and JAX's mesh trainer from the
    same parameters and triplets: epoch loss rtol 1e-3."""
    graph = _tiny_graph(rng, n_nodes=40, dim=32)
    poses = np.tile(np.eye(4, dtype=np.float32), (40, 1, 1))
    poses[:, 0, 3] = np.arange(40) * 2.0
    poses[20:, 0, 3] = poses[:20, 0, 3]
    tri = np.stack([rng.integers(0, 40, 150) for _ in range(3)], 1)
    model_kw = dict(input_dim=32, hidden_dim=16, output_dim=32, dropout=0.0)
    j_mesh = jtrainer.GNNTrainer(model=JaxGNN(**model_kw),
                                 mesh=jpar.create_mesh(8),
                                 checkpoint_dir=str(tmp_path / "j"),
                                 triplets_per_step=64, seed=0)
    kw = dict(checkpoint_dir=str(tmp_path / "t"), triplets_per_step=64,
              seed=0, device="cpu")
    t_single = GNNTrainer(model=SpectralGNN(**model_kw), **kw)
    t_mesh = GNNTrainer(model=SpectralGNN(**model_kw), mesh=_mesh8(), **kw)
    for t in (t_single, t_mesh):
        _load_flax(t, j_mesh.params, j_mesh.batch_stats)
    lj = j_mesh.train_epoch(graph, _Fixed(tri), poses, graph.features)
    l1 = t_single.train_epoch(graph, _Fixed(tri), poses, graph.features)
    l8 = t_mesh.train_epoch(graph, _Fixed(tri), poses, graph.features)
    assert l8 > 0 and t_mesh.global_step == 3
    np.testing.assert_allclose(l8, l1, rtol=1e-3)
    np.testing.assert_allclose(l8, lj, rtol=1e-3)


# ---------------------------------------------------------------------------
# row-sharded retrieval
# ---------------------------------------------------------------------------

def _hists(rng, n, bins):
    h = rng.random((n, bins), dtype=np.float32)
    return h / h.sum(axis=1, keepdims=True)


def _three(n_bins, capacity, **kw):
    """(port sharded on 8 logical shards, port single, JAX sharded)."""
    return (tpar.ShardedWassersteinRetriever(_mesh8(), n_bins=n_bins,
                                             capacity=capacity, **kw),
            WassersteinRetriever(n_bins=n_bins, capacity=capacity,
                                 device="cpu", **kw),
            jpar.ShardedWassersteinRetriever(jpar.create_mesh(8),
                                             n_bins=n_bins,
                                             capacity=capacity, **kw))


def _same_answer(got, single, jax_ans, rtol=1e-5, atol=1e-7):
    """Indices equal the port's single-device retriever's in order and
    JAX's as a set; distances within the bar of both."""
    (i1, d1), (i2, d2), (i3, d3) = got, single, jax_ans
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=rtol, atol=atol)
    assert set(i1.tolist()) == set(np.asarray(i3).tolist())
    np.testing.assert_allclose(np.sort(d1), np.sort(d3), rtol=rtol, atol=atol)


def test_sharded_retriever_matches_single_device(rng):
    n, bins = 64, 50
    hists = _hists(rng, n, bins)
    pos = rng.random((n, 3), dtype=np.float32) * 100
    rs = _three(bins, 64)
    for r in rs:
        r.add_to_database(hists, pos)
    ans = [r.query(hists[7], top_k=5, query_position=pos[7],
                   spatial_min_distance=20.0) for r in rs]
    _same_answer(*ans)


def test_sharded_retriever_partial_fill(rng):
    """A database smaller than one shard slab still answers correctly."""
    h = _hists(rng, 3, 20)
    rs = _three(20, 80)
    assert rs[0].capacity == 80 and rs[0].rows_per_shard == 10
    for r in rs:
        r.add_to_database(h)
    ans = [r.query(h[1], top_k=10) for r in rs]
    idx, dist = ans[0]
    assert len(idx) == 3 and idx[0] == 1 and dist[0] < 1e-6
    _same_answer(*ans)


def test_sharded_query_batch_matches_plain(rng):
    n, bins = 64, 50
    hists = _hists(rng, n, bins)
    pos = rng.random((n, 3), dtype=np.float32) * 100
    rs = _three(bins, 64)
    for r in rs:
        r.add_to_database(hists, pos)
    qs = [3, 17, 42]
    bidx, bdist = rs[0].query_batch(hists[qs], top_k=5,
                                    query_positions=pos[qs],
                                    spatial_min_distance=20.0)
    jidx, jdist = rs[2].query_batch(hists[qs], top_k=5,
                                    query_positions=pos[qs],
                                    spatial_min_distance=20.0)
    for row, qi in enumerate(qs):
        keep = np.isfinite(bdist[row])
        jkeep = np.isfinite(jdist[row])
        _same_answer((bidx[row][keep], bdist[row][keep]),
                     rs[1].query(hists[qi], top_k=5, query_position=pos[qi],
                                 spatial_min_distance=20.0),
                     (jidx[row][jkeep], jdist[row][jkeep]))


def test_sharded_retriever_exclude_last(rng):
    h = _hists(rng, 40, 20)
    rs = _three(20, 64)
    for r in rs:
        r.add_to_database(h)
    ans = [r.query(h[39], top_k=40, exclude_last=10) for r in rs]
    idx, _ = ans[0]
    assert len(idx) == 30 and idx.max() < 30
    _same_answer(*ans)
    snap = [r.query(h[5], top_k=8, as_of_size=20, exclude_last=3)
            for r in rs]
    assert snap[0][0].max() < 17
    _same_answer(*snap)


def test_sharded_retriever_l2_matches_plain(rng):
    """metric="l2": GNN-embedding retrieval sharded as unsharded (rtol
    1e-5, atol 1e-6)."""
    n, dim = 64, 32
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    pos = rng.random((n, 3), dtype=np.float32) * 100
    rs = _three(dim, 64, metric="l2")
    for r in rs:
        r.add_to_database(vecs, pos)
    for qi in (0, 31, 63):
        ans = [r.query(vecs[qi], top_k=5, query_position=pos[qi],
                       spatial_min_distance=20.0) for r in rs]
        _same_answer(*ans, atol=1e-6)


def test_sharded_retriever_update_rows_matches_plain(rng):
    """Row refreshes on several shard slabs, both metrics."""
    n, bins = 64, 50
    for metric in ("wasserstein", "l2"):
        hists = _hists(rng, n, bins)
        rs = _three(bins, 64, metric=metric)
        refresh_idx = np.array([0, 9, 23, 41, 63])
        fresh = _hists(rng, len(refresh_idx), bins)
        for r in rs:
            r.add_to_database(hists)
            r.update_rows(refresh_idx, fresh)
        ans = [r.query(fresh[2], top_k=5) for r in rs]
        assert ans[0][0][0] == 23, (metric, ans[0])
        _same_answer(*ans, atol=1e-6)
        with pytest.raises(IndexError):
            rs[0].update_rows(np.array([64]), fresh[:1])


@pytest.mark.parametrize("metric,storage", [("wasserstein", "float32"),
                                            ("wasserstein", "uint16"),
                                            ("l2", "float32")])
def test_sharded_retriever_tie_order_across_shards(rng, metric, storage):
    """Rows equal to the query on shards 0, 1, 2, 4 and 7 (8 rows a
    slab): the top-5 lists them by the lower global row, as the port's
    single-device retriever and JAX's ``lax.top_k`` (sharded and not)
    order equal distances; the rest follow by distance."""
    n, bins = 64, 20
    rows = (_hists(rng, n, bins) if metric == "wasserstein"
            else rng.normal(size=(n, bins)).astype(np.float32))
    twins = [3, 11, 19, 35, 60]
    rows[twins] = rows[twins[0]]
    rs = _three(bins, n, metric=metric, storage=storage)
    rs += (JaxRetriever(n_bins=bins, capacity=n, metric=metric,
                        storage=storage),)
    for r in rs:
        r.add_to_database(rows)
    ans = [r.query(rows[3], top_k=8) for r in rs]
    assert ans[0][0][:5].tolist() == twins
    for i, _ in ans[1:]:
        np.testing.assert_array_equal(np.asarray(i)[:5], twins)
    np.testing.assert_array_equal(ans[0][0], ans[1][0])
    bidx, _ = rs[0].query_batch(rows[[3, 60]], top_k=8)
    np.testing.assert_array_equal(bidx[0], ans[0][0])
    np.testing.assert_array_equal(bidx[1], ans[0][0])


def test_plain_query_batch_exclude_last(rng):
    """query() / query_batch() parity for temporal exclusion on the
    unsharded retriever (test_parallel.py's rtol 1e-6, atol 1e-7), and
    against JAX's: the same slots, distances within the port's W₁ bar
    (rtol 2e-5: float32 CDF sums in another order)."""
    h = _hists(rng, 40, 20)
    r = WassersteinRetriever(n_bins=20, capacity=64, device="cpu")
    j = JaxRetriever(n_bins=20, capacity=64)
    for x in (r, j):
        x.add_to_database(h)
    bidx, bdist = r.query_batch(h[[39, 5]], top_k=40, exclude_last=10)
    jidx, jdist = j.query_batch(h[[39, 5]], top_k=40, exclude_last=10)
    assert bidx.shape[1] == 40
    finite = np.isfinite(bdist)
    assert finite.sum(axis=1).tolist() == [30, 30]
    assert bidx[finite].max() < 30
    np.testing.assert_array_equal(finite, np.isfinite(jdist))
    np.testing.assert_array_equal(bidx[finite], np.asarray(jidx)[finite])
    np.testing.assert_allclose(bdist[finite], np.asarray(jdist)[finite],
                               rtol=2e-5, atol=0)
    sidx, sdist = r.query(h[39], top_k=40, exclude_last=10)
    keep = np.isfinite(bdist[0])
    np.testing.assert_allclose(np.sort(bdist[0][keep]), np.sort(sdist),
                               rtol=1e-6, atol=1e-7)


def test_plain_query_and_query_batch_same_normalization(rng):
    """Both query paths share one CDF normalisation: identical (even
    unnormalised) inputs give identical W₁ distances, as in JAX."""
    h = rng.random((8, 20), dtype=np.float32) * 3.0
    r = WassersteinRetriever(n_bins=20, capacity=16, device="cpu")
    j = JaxRetriever(n_bins=20, capacity=16)
    for x in (r, j):
        x.add_to_database(h)
    sidx, sdist = r.query(h[3], top_k=8)
    bidx, bdist = r.query_batch(h[[3]], top_k=8)
    np.testing.assert_array_equal(sidx, bidx[0])
    np.testing.assert_allclose(sdist, bdist[0], rtol=0, atol=1e-7)
    jidx, jdist = j.query(h[3], top_k=8)
    np.testing.assert_array_equal(sidx, jidx)
    np.testing.assert_allclose(sdist, jdist, rtol=1e-5, atol=1e-6)


def test_two_stage_sharded_retriever_matches_unsharded(rng):
    """TwoStageRetrieval(mesh=) row-shards stage 1 with the unsharded
    candidates (distances atol 1e-5, test_parallel.py), as JAX's does
    (the same candidates, distances within the port's W₁ bar, rtol
    2e-5); the one-dispatch serving step is refused for it
    (can_fuse_serving)."""
    from neural_spectral_codec_tpu.keyframe.selector import (
        Keyframe as JaxKeyframe)
    from neural_spectral_codec_tpu.retrieval.two_stage import (
        TwoStageRetrieval as JaxTwoStage)
    from neural_spectral_codec_torch.keyframe.selector import Keyframe
    from neural_spectral_codec_torch.retrieval.two_stage import (
        TwoStageRetrieval)

    opts = dict(top_k=5, spatial_filter_distance=0.0, context_window=2,
                capacity=128)
    plain = TwoStageRetrieval(device="cpu", **opts)
    sharded = TwoStageRetrieval(device="cpu", mesh=_mesh8(), **opts)
    jax_sharded = JaxTwoStage(mesh=jpar.create_mesh(8), **opts)
    assert plain.can_fuse_serving() and not sharded.can_fuse_serving()
    for i in range(40):
        d = np.abs(rng.random(800)).astype(np.float32)
        d /= d.sum()
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.random(3) * 500
        for ts, kf_cls in ((plain, Keyframe), (sharded, Keyframe),
                           (jax_sharded, JaxKeyframe)):
            ts.add_keyframe(kf_cls(keyframe_id=i, scan_id=i,
                                   timestamp=float(i), pose=pose,
                                   points=None, descriptor=d))

    def cands(ts, q, **kw):
        c = ts._global_retrieval(ts.keyframes[q], **kw)
        return [x.database_idx for x in c], [x.distance for x in c]

    for q in range(5, 35, 7):
        (i1, d1), (i2, d2), (i3, d3) = (cands(t, q) for t in
                                        (plain, sharded, jax_sharded))
        assert i1 == i2 == i3
        np.testing.assert_allclose(d1, d2, atol=1e-5)
        np.testing.assert_allclose(d2, d3, rtol=2e-5, atol=0)
    snaps = [cands(t, 10, as_of_size=20)[0]
             for t in (plain, sharded, jax_sharded)]
    assert snaps[0] == snaps[1] == snaps[2]


def test_pipeline_config_shards_retrieval_db(tmp_path, monkeypatch, caplog):
    """parallel.shard_retrieval_db with more than one device of the
    pipeline's type (the device count monkeypatched to 4 logical CPUs)
    wires the sharded retriever in, over ``system.mesh_devices`` of them,
    as JAX's pipeline does on its 8 devices; with one device it warns and
    keeps the unsharded retriever."""
    from test_pipeline import small_config
    from neural_spectral_codec_tpu.pipeline import (
        NeuralSpectralCodecPipeline as JaxPipeline)
    from neural_spectral_codec_torch.parallel.retrieval import (
        ShardedWassersteinRetriever)
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline)

    cfg = small_config(tmp_path)
    cfg.setdefault("parallel", {})["shard_retrieval_db"] = True
    assert isinstance(JaxPipeline(cfg).retrieval.retriever,
                      jpar.ShardedWassersteinRetriever)
    with caplog.at_level(logging.WARNING):
        one = NeuralSpectralCodecPipeline(cfg, device="cpu")
    assert type(one.retrieval.retriever) is WassersteinRetriever
    assert "only one device present" in caplog.text
    monkeypatch.setattr(tmesh, "devices_of", lambda t: [CPU] * 4)
    four = NeuralSpectralCodecPipeline(cfg, device="cpu")
    assert isinstance(four.retrieval.retriever, ShardedWassersteinRetriever)
    assert four.retrieval.retriever.mesh.size == 4
    cfg["system"]["mesh_devices"] = 2
    two = NeuralSpectralCodecPipeline(cfg, device="cpu")
    assert two.retrieval.retriever.mesh.size == 2


def test_pipeline_data_parallel_trains_on_the_mesh(tmp_path, monkeypatch):
    """parallel.data_parallel (on by default) with more than one device
    trains over the mesh (parallel.shard_graph_nodes: nodes sharded
    too); with one device, or the key off, on the pipeline's device."""
    from test_pipeline import small_config
    from neural_spectral_codec_torch.data.synthetic import SyntheticLoader
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline)

    def train(**parallel):
        cfg = small_config(tmp_path, training={"n_epochs": 1},
                           triplet={"positive_temporal_min": 5,
                                    "negative_temporal_min": 5})
        cfg.setdefault("parallel", {}).update(parallel)
        pipe = NeuralSpectralCodecPipeline(cfg, device="cpu")
        return pipe.train_offline([SyntheticLoader(
            n_frames=40, seed=0, n_points=2048, loops=2.0)])

    t = train()
    assert t.mesh is None
    monkeypatch.setattr(tmesh, "devices_of", lambda t: [CPU] * 2)
    t = train(shard_graph_nodes=True)
    assert t.mesh.size == 2 and t.shard_nodes and t.global_step > 0
    assert np.isfinite(t.train_losses).all() and t.train_losses[0] > 0
    assert train(data_parallel=False).mesh is None


def test_sharded_retriever_quantized_matches_unsharded(rng):
    """uint16 storage row-sharded: the same codes, ranking and distances
    as the port's unsharded uint16 retriever; against JAX's sharded
    uint16 retriever the same rows, distances within one code
    (4/65535, test_torch_quantization.py: the frameworks' CDFs differ by
    ~1e-7, so a code near a midpoint can differ); top-k equal to float32
    storage with distances within n_bins · 0.5/65535."""
    n, bins = 64, 50
    hists = _hists(rng, n, bins)
    pos = rng.random((n, 3), dtype=np.float32) * 100
    sharded, plain16, jax16 = _three(bins, 64, storage="uint16")
    plain32 = WassersteinRetriever(n_bins=bins, capacity=64, device="cpu")
    for r in (sharded, plain16, jax16, plain32):
        r.add_to_database(hists, pos)
    assert all(s.dtype == torch.uint16 for s in sharded._slab_rows)
    kw = dict(top_k=5, query_position=pos[7], spatial_min_distance=20.0)
    i_s, d_s = sharded.query(hists[7], **kw)
    i_16, d_16 = plain16.query(hists[7], **kw)
    i_j, d_j = jax16.query(hists[7], **kw)
    i_32, d_32 = plain32.query(hists[7], **kw)
    np.testing.assert_array_equal(i_s, i_16)
    np.testing.assert_array_equal(d_s, d_16)
    assert set(i_s.tolist()) == set(i_j.tolist()) == set(i_32.tolist())
    assert np.max(np.abs(np.sort(d_s) - np.sort(d_j))) <= 4 / 65535
    assert np.max(np.abs(np.sort(d_s) - np.sort(d_32))) <= \
        bins * 0.5 / 65535 + 1e-6


# ---------------------------------------------------------------------------
# dryrun
# ---------------------------------------------------------------------------

def test_dryrun_multichip_on_logical_cpu_shards():
    """``dryrun_multichip`` runs its steps and asserts on 4 logical CPU
    shards (the card runs it in chip_smoke.py phase 10)."""
    from neural_spectral_codec_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(4, devices=[CPU] * 4)
    assert np.isfinite(out["loss"]) and out["n_queries"] > 0


def test_scale_100k_compare_sharded_on_logical_shards():
    """``scale_100k --compare-sharded`` (JAX's option) on 3 logical CPU
    shards at 300 nodes, full width, dropout 0.1: both trainers' first
    step losses agree within the JAX script's bar (the function asserts
    it) and a time per step comes back for each."""
    from neural_spectral_codec_torch.experiments import scale_100k
    out = scale_100k.main(["--nodes", "300", "--device", "cpu",
                           "--compare-sharded", "--shards", "3"])
    assert out["shards"] == 3 and out["sharded_first_loss"] > 0
    assert out["single_ms_per_step"] > 0 and out["sharded_ms_per_step"] > 0


def test_online_loop_with_sharded_stage1_closes_the_same_loops(
        monkeypatch):
    """``run_online`` with ``parallel.shard_retrieval_db`` on 4 logical
    CPU shards (the device count monkeypatched) takes the split serving
    path (``can_fuse_serving`` is false) and closes the same loops, with
    the same stage-1 rows, as the unsharded one-dispatch run."""
    from test_torch_online import small_config as online_config
    from neural_spectral_codec_torch.data.synthetic import SyntheticLoader
    from neural_spectral_codec_torch.parallel.retrieval import (
        ShardedWassersteinRetriever)
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline)

    def run(shard):
        cfg = online_config(parallel={"shard_retrieval_db": shard})
        pipe = NeuralSpectralCodecPipeline(cfg, device="cpu")
        edges = pipe.run_online(SyntheticLoader(n_frames=100, seed=0,
                                                n_points=4096, loops=2.0),
                                loop_closure_interval=10)
        return pipe, sorted((e["source_id"], e["target_id"]) for e in edges)

    plain, want = run(False)
    monkeypatch.setattr(tmesh, "devices_of", lambda t: [CPU] * 4)
    sharded, got = run(True)
    ret = sharded.retrieval.retriever
    assert isinstance(ret, ShardedWassersteinRetriever)
    assert not sharded.retrieval.can_fuse_serving()
    assert got == want and len(want) > 0
    n = ret.database_size
    assert n == plain.retrieval.retriever.database_size
    rows = torch.cat(ret._slab_rows)[:n]
    np.testing.assert_allclose(rows.numpy(),
                               plain.retrieval.retriever._db_rows[:n].numpy(),
                               rtol=0, atol=1e-6)
