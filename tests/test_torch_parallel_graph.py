"""The port's sharded executables on the CPU, where their static steps run
eagerly: ``parallel.train.ShardedTrainStepExecutable`` (DP and
node-sharded), ``ShardedEvalExecutable``, ``validation.RecallExecutable``
on a one-device mesh and the row-sharded retriever's query step
(``retriever.QueryExecutable`` over ``ShardedWassersteinRetriever.rank``).

Each is held against the eager sharded function on the same input, bit
for bit, and against JAX's sharded program on 8 virtual CPU devices at
``tests/test_torch_parallel.py``'s bars: loss rtol 1e-5, atol 1e-6;
gradients 3e-5 + 2e-5·max|g|; eval 1e-5; recall counts equal; query
indices equal, ties by the lower row. The sharded triplet gathers go
through kernel G's ``gather_rows`` (their plans counted); a mesh over
distinct devices runs op by op, and every op-by-op sharded step or
forward is counted. Shapes: ``Mesh([cpu] * 8)``, a
16-node graph, a 32 → 16 → 32 GNN."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neural_spectral_codec_tpu import parallel as jpar  # noqa: E402
from neural_spectral_codec_tpu.parallel.train import (  # noqa: E402
    make_sharded_eval_step as jax_eval_step)
from neural_spectral_codec_tpu.training import (  # noqa: E402
    trainer as jtrainer)
from neural_spectral_codec_tpu.training import (  # noqa: E402
    validation as jval)
from neural_spectral_codec_torch import parallel as tpar  # noqa: E402
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: E402
    pad_graph)
from neural_spectral_codec_torch.models import (  # noqa: E402
    SpectralGNN, gather_kernel, gnn)
from neural_spectral_codec_torch.parallel import mesh as tmesh  # noqa: E402
from neural_spectral_codec_torch.parallel.train import (  # noqa: E402
    ShardedEvalExecutable, ShardedTrainStepExecutable,
    make_sharded_eval_step, place_graph)
from neural_spectral_codec_torch.retrieval import (  # noqa: E402
    retriever as retriever_mod)
from neural_spectral_codec_torch.training import (  # noqa: E402
    trainer as trainer_mod)
from neural_spectral_codec_torch.training import (  # noqa: E402
    validation as tval)
from neural_spectral_codec_torch.training.trainer import (  # noqa: E402
    GNNTrainer, make_optimizer)
from test_torch_parallel import (  # noqa: E402
    _grads_close, _hists, _jax_sharded_loss_grads, _mesh8, _small_models,
    _tiny_graph)
from test_torch_serve_graph import HOST_SYNCS, _Ops  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
MODES = [pytest.param(False, id="dp"), pytest.param(True, id="nodes")]


def _several_devices(monkeypatch):
    """Make every mesh count as spanning distinct devices, so the sharded
    programs take their op-by-op path (a CPU has one device)."""
    monkeypatch.setattr(tmesh.Mesh, "one_device", property(lambda m: False))


def _state(model, opt) -> list:
    """A model's parameters and buffers and its optimizer's state."""
    out = [t.detach().clone() for t in model.state_dict().values()]
    for st in opt.state_dict()["state"].values():
        out += [torch.as_tensor(v).clone() for _, v in sorted(st.items())]
    return out


def _triplets(rng, n_nodes, n_valid, batch):
    tri = np.zeros((batch, 3), np.int64)
    tri[:n_valid] = rng.integers(0, n_nodes, (n_valid, 3))
    tri[n_valid:] = 5          # padded triplets point at a real row
    return tri, np.arange(batch) < n_valid


def _executable(model, opt, mesh, shard_nodes, graph, batch, gen=None,
                clip=1.0):
    exe = ShardedTrainStepExecutable(
        model, opt, mesh, shard_nodes, graph.n_nodes, graph.max_degree,
        graph.edge_feats.shape[2], batch, 0.1, clip, False, gen)
    exe.load_graph(graph)
    return exe


@pytest.mark.parametrize("shard_nodes", MODES)
def test_sharded_train_executable_equals_the_eager_step(rng, shard_nodes):
    """Three Adam steps (clip 1.0, dropout 0.3 from a seeded generator, 3
    of 16 triplets padded) through the executable give the eager sharded
    step's losses, parameters, BatchNorm buffers, Adam state and
    generator state, bit for bit; each run counts one eager step, and
    each call of the op-by-op step one ``sharded_op_by_op``."""
    graph = _tiny_graph(rng, n_nodes=16, dim=32)
    tri, tmask = _triplets(rng, 16, 13, 16)
    mesh = _mesh8()

    def fresh():
        model = SpectralGNN(input_dim=32, hidden_dim=16, output_dim=32,
                            dropout=0.3,
                            generator=torch.Generator().manual_seed(0))
        return model, make_optimizer(model), torch.Generator().manual_seed(7)

    m1, o1, g1 = fresh()
    exe = _executable(m1, o1, mesh, shard_nodes, graph, 16, g1)
    eager = trainer_mod.STATS["eager_steps"]
    got = [float(exe.run({"triplets": tri, "tmask": tmask})[0]["loss"])
           for _ in range(3)]
    assert trainer_mod.STATS["eager_steps"] == eager + 3
    m2, o2, g2 = fresh()
    step = tpar.make_sharded_train_step(m2, o2, mesh,
                                        shard_nodes=shard_nodes)
    placed = place_graph(graph, mesh, shard_nodes)
    t, mask = torch.from_numpy(tri), torch.from_numpy(tmask)
    op_by_op = trainer_mod.STATS["sharded_op_by_op"]
    want = [float(step(placed, t[:, 0], t[:, 1], t[:, 2], mask, 0.1, g2))
            for _ in range(3)]
    assert trainer_mod.STATS["sharded_op_by_op"] == op_by_op + 3
    assert got == want and got[0] > 0
    for a, b in zip(_state(m1, o1), _state(m2, o2)):
        assert torch.equal(a, b)
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("shard_nodes", MODES)
def test_sharded_train_executable_matches_jax(rng, shard_nodes):
    """The executable's loss and raw gradients (SGD at lr 0, no clip) on
    16 triplets equal JAX's sharded value_and_grad at loss rtol 1e-5,
    atol 1e-6 and gradients 3e-5 + 2e-5·max|g|; then three Adam steps
    (clip 1.0) track JAX's jitted sharded step within
    test_torch_parallel.py's 1e-4 a step."""
    jm, params, bs, tm = _small_models()
    graph = _tiny_graph(rng, n_nodes=16, dim=32)
    tri = rng.integers(0, 16, (16, 3))
    tmask = np.ones(16, bool)
    j_loss, j_grads = _jax_sharded_loss_grads(jm, params, bs, graph, tri,
                                              shard_nodes)
    exe = _executable(tm, torch.optim.SGD(tm.parameters(), lr=0.0),
                      _mesh8(), shard_nodes, graph, 16, clip=None)
    loss = float(exe.run({"triplets": tri, "tmask": tmask})[0]["loss"])
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5, atol=1e-6)
    _grads_close({k: p.grad.numpy() for k, p in tm.named_parameters()},
                 j_grads, 2e-5)

    tm = _small_models()[3]
    exe = _executable(tm, make_optimizer(tm), _mesh8(), shard_nodes, graph,
                      16)
    jopt = jtrainer.make_optimizer()
    jstep = jpar.make_sharded_train_step(jm, jopt, jpar.create_mesh(8),
                                         shard_nodes=shard_nodes)
    jstate = (params, bs, jopt.init(params))
    g = (jnp.asarray(graph.features), jnp.asarray(graph.neighbors),
         jnp.asarray(graph.mask), jnp.asarray(graph.edge_feats))
    jtr = (jnp.asarray(tri[:, 0]), jnp.asarray(tri[:, 1]),
           jnp.asarray(tri[:, 2]), jnp.asarray(tmask))
    for i in range(3):
        got = float(exe.run({"triplets": tri, "tmask": tmask})[0]["loss"])
        *jstate, jl = jstep(*jstate, *g, *jtr, 0.1, jax.random.key(i))
        np.testing.assert_allclose(got, float(jl), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shard_nodes", MODES)
def test_sharded_triplet_gathers_go_through_kernel_g(rng, monkeypatch,
                                                     shard_nodes):
    """A sharded step's gathers all go through ``gather_rows``, whose
    backward is kernel G: under DP each replica's 3 GAT gathers and its
    slab's 3 triplet gathers (8 × 6), node-sharded 3 a slab and 3 triplet
    gathers (3 × 8 + 3), the count a card's train graph must hold
    (``gathers()``). The triplet plans leave the padded triplets (mask
    off, pointing at row 5) out of every segment, so they add nothing."""
    from neural_spectral_codec_torch.parallel import train as ptrain
    plans, triplet = [], []
    bwd, rows = gather_kernel.gather_bwd, ptrain.gather_rows

    def counting_bwd(grad, plan, n_rows):
        plans.append(int(plan.offsets[-1]))
        return bwd(grad, plan, n_rows)

    def counting_rows(src, idx, plan=None, valid=None):
        triplet.append((len(idx), int(valid.sum())))
        return rows(src, idx, plan, valid)

    monkeypatch.setattr(gather_kernel, "gather_bwd", counting_bwd)
    monkeypatch.setattr(ptrain, "gather_rows", counting_rows)
    graph = _tiny_graph(rng, n_nodes=16, dim=32)
    tri, tmask = _triplets(rng, 16, 13, 16)
    tm = _small_models()[3]
    mesh = _mesh8()
    exe = _executable(tm, torch.optim.SGD(tm.parameters(), lr=0.0), mesh,
                      shard_nodes, graph, 16, clip=None)
    exe.run({"triplets": tri, "tmask": tmask})
    assert len(plans) == exe.gathers() == (27 if shard_nodes else 48)
    shares = [tmask] if shard_nodes else np.split(tmask, 8)
    assert triplet == [(len(m), int(m.sum())) for m in shares
                       for _ in range(3)]


@pytest.mark.parametrize("shard_nodes", MODES)
def test_sharded_train_step_has_no_host_sync(rng, monkeypatch, shard_nodes):
    """The sharded step's body (forward, replicas, dropout draws handed
    over, gathers, loss, backward, clip, SGD) dispatches no operation that
    reads a value back to the host, which would break its capture on a
    card. G's CPU plain version reads its longest segment on the host, so
    it is replaced here by the same sums through ``index_add_``."""
    def stand_in(grad, plan, n_rows):
        at = torch.arange(plan.order.shape[0])
        row = torch.searchsorted(plan.offsets[1:].long(), at, right=True)
        return torch.zeros((n_rows + 1, grad.shape[1])).index_add_(
            0, row, grad[plan.order.long()])[:n_rows]

    graph = _tiny_graph(rng, n_nodes=16, dim=32)
    tri, tmask = _triplets(rng, 16, 13, 16)
    model = SpectralGNN(input_dim=32, hidden_dim=16, output_dim=32,
                        dropout=0.3,
                        generator=torch.Generator().manual_seed(0))
    exe = _executable(model, torch.optim.SGD(model.parameters(), lr=0.1),
                      _mesh8(), shard_nodes, graph, 16,
                      torch.Generator().manual_seed(1))
    exe.run({"triplets": tri, "tmask": tmask})
    monkeypatch.setattr(gather_kernel, "gather_bwd", stand_in)
    with _Ops() as rec:
        exe._step()
    syncs = [op for op in rec.ops if any(s in op for s in HOST_SYNCS)]
    assert rec.ops and not syncs, syncs


@pytest.mark.parametrize("shard_nodes", MODES)
def test_sharded_eval_executable(rng, shard_nodes):
    """The sharded eval forward of a 21-node graph padded to 24: the
    executable's embeddings equal the eager sharded forward's bit for bit
    and JAX's jitted sharded eval step's within 1e-5 (only the op-by-op
    forward counted as such); the body reads nothing back to the host."""
    jm, params, bs, tm = _small_models()
    tm.eval()
    graph = pad_graph(_tiny_graph(rng, n_nodes=21, dim=32), 24)
    mesh = _mesh8()
    exe = ShardedEvalExecutable(tm, mesh, shard_nodes, 24, graph.max_degree,
                                graph.edge_feats.shape[2])
    eager, op_by_op = gnn.STATS["eager_steps"], gnn.STATS["sharded_op_by_op"]
    got = exe.run(graph._asdict())[0]["emb"]
    assert gnn.STATS["eager_steps"] == eager + 1
    assert gnn.STATS["sharded_op_by_op"] == op_by_op
    want = make_sharded_eval_step(tm, mesh, shard_nodes)(
        place_graph(graph, mesh, shard_nodes)).numpy()
    assert gnn.STATS["sharded_op_by_op"] == op_by_op + 1
    np.testing.assert_array_equal(got, want)
    j = np.asarray(jax_eval_step(jm, jpar.create_mesh(8),
                                 shard_nodes=shard_nodes)(
        params, bs, *(jnp.asarray(a) for a in graph)))
    np.testing.assert_allclose(got, j, rtol=1e-5, atol=1e-5)
    with _Ops() as rec:
        exe._step()
    syncs = [op for op in rec.ops if any(s in op for s in HOST_SYNCS)]
    assert rec.ops and not syncs, syncs


def _loop_poses(n, period=10):
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ang = np.arange(n) * 2 * np.pi / period
    poses[:, 0, 3] = 30.0 * np.cos(ang)
    poses[:, 1, 3] = 30.0 * np.sin(ang)
    return poses


def test_trainer_mesh_embed_and_epoch_run_the_executables(rng, tmp_path):
    """``GNNTrainer(mesh)`` embeds through one ``ShardedEvalExecutable`` a
    padded graph shape, kept across calls, and trains through one
    ``ShardedTrainStepExecutable`` a run; embeddings equal the eager
    sharded forward's, the epoch's loss and state equal the op-by-op
    trainer's (``test_several_devices_run_op_by_op``)."""
    graph = _tiny_graph(rng, n_nodes=21, dim=32)
    kw = dict(model=SpectralGNN(input_dim=32, hidden_dim=16,
                                output_dim=32), mesh=_mesh8(),
              shard_nodes=True, seed=0, checkpoint_dir=str(tmp_path),
              device="cpu", triplets_per_step=16)
    t = GNNTrainer(**kw)
    emb = t.embed(graph)
    assert emb.shape == (21, 32) and t.embed(graph) is not emb
    (exe,) = t._embed_exes.values()
    assert isinstance(exe, ShardedEvalExecutable)
    want = make_sharded_eval_step(t.model, t.mesh)(place_graph(
        pad_graph(graph, 24), t.mesh, True))[:21].numpy()
    np.testing.assert_array_equal(emb, want)

    class Fixed:
        def mine_triplets(self, **kw):
            return tri

    tri = rng.integers(0, 21, (40, 3))
    loss = t.train_epoch(graph, Fixed(), _loop_poses(21), graph.features)
    assert isinstance(t._train_exe, ShardedTrainStepExecutable)
    assert t.global_step == 3 and loss > 0


def test_sharded_recall_executable(rng):
    """``recall_at_ks(mesh=)`` on a one-device mesh runs the
    single-device recall step (chunks of 7 queries, the last padded; one
    step a chunk, nothing op by op): the hit counts of the single-device
    pass and of JAX's 8-device mesh pass, with tied embeddings (ties by
    the lower index)."""
    n = 40
    emb = rng.normal(size=(n, 16)).astype(np.float32)
    emb[20:] = emb[:20]                     # every revisit ties
    emb[25] = emb[3]
    poses = _loop_poses(n)
    kw = dict(distance_threshold=1.0, skip_frames=9)
    mesh = _mesh8()
    before = dict(tval.STATS)
    got = tval.recall_at_ks(emb, poses, (1, 3), query_chunk=7, mesh=mesh,
                            **kw)
    assert got[1] > 7
    assert tval.STATS["sharded_op_by_op"] == before["sharded_op_by_op"]
    assert any(isinstance(e, tval.RecallExecutable)
               and e.inputs.dev["queries"].shape[0] == 7
               for e in tval.cached_executables())
    chunks = -(-got[1] // 7)
    assert tval.STATS["eager_steps"] >= before["eager_steps"] + chunks
    one = tval.recall_at_ks(emb, poses, (1, 3), query_chunk=7, device="cpu",
                            **kw)
    assert got == one
    for k in (1, 3):
        j = jval.recall_loop_closure(emb, poses, k, mesh=jpar.create_mesh(8),
                                     **kw)
        assert (got[0][k], got[1]) == j


def test_sharded_recall_body_has_no_host_sync(rng):
    mesh = tpar.Mesh([CPU] * 3)
    emb = rng.normal(size=(30, 8)).astype(np.float32)
    tval.recall_at_ks(emb, _loop_poses(30), (1,), query_chunk=5, mesh=mesh,
                      distance_threshold=1.0, skip_frames=9)
    exe = [e for e in tval.cached_executables()
           if isinstance(e, tval.RecallExecutable)
           and e.inputs.dev["queries"].shape[0] == 5][-1]
    with _Ops() as rec:
        exe._step()
    syncs = [op for op in rec.ops if any(s in op for s in HOST_SYNCS)]
    assert rec.ops and not syncs, syncs


def _sharded_pair(metric, storage, rows, pos=None):
    """(port sharded on 8 slabs of 8 rows, JAX sharded), both filled."""
    n, bins = rows.shape
    port = tpar.ShardedWassersteinRetriever(_mesh8(), n_bins=bins,
                                            capacity=n, metric=metric,
                                            storage=storage)
    jax_r = jpar.ShardedWassersteinRetriever(jpar.create_mesh(8),
                                             n_bins=bins, capacity=n,
                                             metric=metric, storage=storage)
    for r in (port, jax_r):
        r.add_to_database(rows, pos)
    return port, jax_r


@pytest.mark.parametrize("metric,storage", [("wasserstein", "float32"),
                                            ("wasserstein", "uint16"),
                                            ("l2", "float32")])
def test_sharded_query_executable(rng, metric, storage):
    """``query_batch`` and ``query`` on a one-device mesh run the query
    step (``rank`` over the slabs, each slab's size clamped on the
    device): the op-by-op ``rank``'s indices and distances bit for bit at
    effective sizes inside, at and across slab edges, and JAX's sharded
    retriever's indices, twins on 5 slabs listed by the lower row; no
    query counted as op by op."""
    n, bins = 64, 20
    rows = (_hists(rng, n, bins) if metric == "wasserstein"
            else rng.normal(size=(n, bins)).astype(np.float32))
    twins = [3, 11, 19, 35, 60]
    rows[twins] = rows[twins[0]]
    pos = rng.random((n, 3), dtype=np.float32) * 100
    port, jax_r = _sharded_pair(metric, storage, rows, pos)
    sharded = retriever_mod.STATS["sharded"]
    eager = retriever_mod.STATS["eager_steps"]
    q = rows[[3, 17, 42]]
    for excl in (0, 4, 8, 29):
        idx, dist = port.query_batch(q, top_k=8, exclude_last=excl)
        eff = n - excl
        want_i, want_d = port.rank(torch.from_numpy(q),
                                   torch.zeros((3, 4)), 8, eff)
        np.testing.assert_array_equal(dist, want_d.numpy())
        np.testing.assert_array_equal(
            idx, np.where(np.isfinite(dist), want_i.numpy(), -1))
        jidx, _ = jax_r.query_batch(q, top_k=8, exclude_last=excl)
        np.testing.assert_array_equal(idx, np.asarray(jidx))
        tied = [t for t in twins if t < eff]
        assert idx[0][:len(tied)].tolist() == tied
    i1, _ = port.query(rows[3], top_k=8, query_position=pos[3],
                       spatial_min_distance=20.0, as_of_size=40,
                       exclude_last=3)
    j1, _ = jax_r.query(rows[3], top_k=8, query_position=pos[3],
                        spatial_min_distance=20.0, as_of_size=40,
                        exclude_last=3)
    np.testing.assert_array_equal(i1, np.asarray(j1))
    assert retriever_mod.STATS["sharded"] == sharded
    assert retriever_mod.STATS["eager_steps"] == eager + 5
    (exe,) = [e for e in retriever_mod.cached_executables()
              if e._retriever() is port and e.n_queries == 3]
    with _Ops() as rec:
        exe._step()
    syncs = [op for op in rec.ops if any(s in op for s in HOST_SYNCS)]
    assert rec.ops and not syncs, syncs


def test_several_devices_run_op_by_op(rng, tmp_path, monkeypatch):
    """A mesh over distinct devices runs each sharded program op by op,
    counted apart (``sharded_op_by_op``, the retriever's ``sharded``), with
    the answers of the one-device executables: an epoch's loss and model
    state, the embeddings, the recall and a query equal. The executables
    refuse such a mesh."""
    graph = _tiny_graph(rng, n_nodes=21, dim=32)
    tri = rng.integers(0, 21, (40, 3))

    class Fixed:
        def mine_triplets(self, **kw):
            return tri

    def run():
        t = GNNTrainer(model=SpectralGNN(input_dim=32, hidden_dim=16,
                                         output_dim=32), mesh=_mesh8(),
                       shard_nodes=False, seed=0,
                       checkpoint_dir=str(tmp_path), device="cpu",
                       triplets_per_step=16)
        loss = t.train_epoch(graph, Fixed(), _loop_poses(21),
                             graph.features)
        return loss, t.model.state_dict(), t.embed(graph)

    def recall_and_query():
        rows = _hists(np.random.default_rng(1), 64, 20)
        r = tpar.ShardedWassersteinRetriever(_mesh8(), n_bins=20,
                                             capacity=64)
        r.add_to_database(rows)
        return (tval.recall_at_ks(rows[:40], _loop_poses(40), (1, 2),
                                  query_chunk=7, mesh=_mesh8(),
                                  distance_threshold=1.0, skip_frames=9),
                r.query_batch(rows[:3], top_k=5, exclude_last=9))

    op_by_op = (trainer_mod.STATS["sharded_op_by_op"],
                gnn.STATS["sharded_op_by_op"],
                tval.STATS["sharded_op_by_op"])
    one = run(), recall_and_query()
    assert op_by_op == (trainer_mod.STATS["sharded_op_by_op"],
                        gnn.STATS["sharded_op_by_op"],
                        tval.STATS["sharded_op_by_op"])
    _several_devices(monkeypatch)
    before = (dict(trainer_mod.STATS), dict(gnn.STATS), dict(tval.STATS),
              retriever_mod.STATS["sharded"])
    several = run(), recall_and_query()
    assert trainer_mod.STATS["sharded_op_by_op"] == before[0][
        "sharded_op_by_op"] + 3
    assert trainer_mod.STATS["eager_steps"] == before[0]["eager_steps"]
    assert gnn.STATS["sharded_op_by_op"] == before[1]["sharded_op_by_op"] + 1
    assert tval.STATS["sharded_op_by_op"] > before[2]["sharded_op_by_op"]
    assert retriever_mod.STATS["sharded"] == before[3] + 1
    (l1, s1, e1), (r1, (qi1, qd1)) = one
    (l2, s2, e2), (r2, (qi2, qd2)) = several
    assert l1 == l2 and r1 == r2
    assert all(torch.equal(v, s2[k]) for k, v in s1.items())
    np.testing.assert_array_equal(e1, e2)
    np.testing.assert_array_equal(qi1, qi2)
    np.testing.assert_array_equal(qd1, qd2)
    model = SpectralGNN(input_dim=32, hidden_dim=16, output_dim=32)
    with pytest.raises(ValueError, match="op by op"):
        ShardedEvalExecutable(model.eval(), _mesh8(), True, 24, 6, 2)


@pytest.mark.parametrize("several", [pytest.param(False, id="one_device"),
                                     pytest.param(True, id="several")])
def test_dryrun_runs_the_sharded_executables(monkeypatch, several):
    """``dryrun_multichip`` on a one-device mesh of 2 logical CPU shards
    runs its train step and eval forward as the trainer does, through
    the sharded executables (one eager step each on the CPU, nothing
    counted op by op); over distinct devices through the op-by-op
    programs, each call counted in ``sharded_op_by_op``."""
    from neural_spectral_codec_torch.parallel.dryrun import dryrun_multichip
    if several:
        _several_devices(monkeypatch)
    before = (dict(trainer_mod.STATS), dict(gnn.STATS))
    out = dryrun_multichip(2, devices=[CPU] * 2)
    assert np.isfinite(out["loss"]) and out["n_queries"] > 0
    steps = (trainer_mod.STATS["eager_steps"] - before[0]["eager_steps"],
             gnn.STATS["eager_steps"] - before[1]["eager_steps"])
    op_by_op = (trainer_mod.STATS["sharded_op_by_op"]
                - before[0]["sharded_op_by_op"],
                gnn.STATS["sharded_op_by_op"]
                - before[1]["sharded_op_by_op"])
    assert (steps, op_by_op) == (((0, 0), (1, 1)) if several
                                 else ((1, 1), (0, 0)))


def test_pipeline_warmup_builds_the_sharded_query_step(monkeypatch):
    """With ``parallel.shard_retrieval_db`` on a mesh of one device (the
    device count monkeypatched to 4 logical CPUs), ``warmup()`` builds the
    sharded retriever's Q = 1 query step, as it builds the unsharded
    one's, so a session builds none mid-stream."""
    from test_torch_online import small_config
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline)
    monkeypatch.setattr(tmesh, "devices_of", lambda t: [CPU] * 4)
    cfg = small_config(parallel={"shard_retrieval_db": True},
                       deployment={"warmup": False})
    pipe = NeuralSpectralCodecPipeline(cfg, device="cpu")
    ret = pipe.retrieval.retriever
    assert isinstance(ret, tpar.ShardedWassersteinRetriever)
    pipe.warmup()
    mine = [e for e in retriever_mod.cached_executables()
            if e._retriever() is ret]
    assert [(e.n_queries, e.top_k) for e in mine] == [
        (1, int(min(pipe.retrieval.top_k, ret.capacity)))]
    assert ret.database_size == 0
