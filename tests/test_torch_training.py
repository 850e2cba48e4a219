"""PyTorch port vs the JAX reference: the offline training modules (W₁
variants, triplet loss, triplet mining, Recall@K validation, the train
step and optimizer, the trainer). Small shapes (≤ 150 nodes, hidden
width ≤ 32) except the train steps, which run the full-width network on
64 nodes. Each case states its tolerance."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from neural_spectral_codec_tpu.data.synthetic import (  # noqa: E402
    loop_trajectory)
from neural_spectral_codec_tpu.keyframe.graph import (  # noqa: E402
    build_graph)
from neural_spectral_codec_tpu.models.gnn import (  # noqa: E402
    SpectralGNN as JaxGNN, init_gnn)
from neural_spectral_codec_tpu.ops import wasserstein as jw  # noqa: E402
from neural_spectral_codec_tpu.training import loss as jloss  # noqa: E402
from neural_spectral_codec_tpu.training import miner as jminer  # noqa: E402
from neural_spectral_codec_tpu.training import (  # noqa: E402
    trainer as jtrainer)
from neural_spectral_codec_tpu.training import (  # noqa: E402
    validation as jval)
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: E402
    graph_to_tensors)
from neural_spectral_codec_torch.models import (  # noqa: E402
    SpectralGNN, from_flax)
from neural_spectral_codec_torch.models.convert import (  # noqa: E402
    from_optax_adam)
from neural_spectral_codec_torch.models.gnn import (  # noqa: E402
    gauge_parameters)
from neural_spectral_codec_torch.ops import wasserstein as tw  # noqa: E402
from neural_spectral_codec_torch.training import loss as tloss  # noqa: E402
from neural_spectral_codec_torch.training import miner as tminer  # noqa: E402
from neural_spectral_codec_torch.training import (  # noqa: E402
    validation as tval)
from neural_spectral_codec_torch.training.trainer import (  # noqa: E402
    GNNTrainer, make_optimizer, train_step)

torch.set_num_threads(2)
PARAMS = np.array([5.0, 30, 10.0, 50.0, 30], np.float32)   # miner defaults


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------- W₁ ----------------

def test_wasserstein_variants_match_jax():
    """wasserstein_1d, _batch, _matrix and _matrix_chunked (chunk 4 over
    7 rows) with both normalisation guards hit: an all-zero row and a row
    summing to 5e-9 < ε stay unnormalised. rtol 1e-5, atol 1e-6 (float32
    cumsums and |Δ|-sums in other orders; the serving W₁ bar is 2e-5)."""
    rng = np.random.default_rng(0)
    h1 = rng.random((7, 50)).astype(np.float32)
    h2 = rng.random((9, 50)).astype(np.float32)
    h1[2] = 0.0
    h2[4] = 1e-10
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tw.wasserstein_1d(_t(h1), _t(h2[:7])).numpy(),
        np.asarray(jw.wasserstein_1d(h1, h2[:7])), **tol)
    for q in (h1[0], h1[2]):
        np.testing.assert_allclose(
            tw.wasserstein_batch(_t(q), _t(h2)).numpy(),
            np.asarray(jw.wasserstein_batch(q, h2)), **tol)
    want = np.asarray(jw.wasserstein_matrix(h1, h2))
    np.testing.assert_allclose(tw.wasserstein_matrix(_t(h1), _t(h2)).numpy(),
                               want, **tol)
    got = tw.wasserstein_matrix_chunked(_t(h1), _t(h2), chunk=4).numpy()
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(
        got, np.asarray(jw.wasserstein_matrix_chunked(h1, h2, chunk=4)),
        **tol)


# ---------------- loss ----------------

@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_triplet_loss_matches_jax(use_mask, normalize):
    """Masked / unmasked, raw / L2-normalised: loss ≤ 1e-6 from JAX."""
    rng = np.random.default_rng(1)
    a, p, n = (rng.normal(size=(33, 24)).astype(np.float32) * 0.3
               for _ in range(3))
    mask = rng.random(33) < 0.7 if use_mask else None
    want = float(jloss.triplet_loss(a, p, n, 0.1, mask=mask,
                                    normalize=normalize))
    got = float(tloss.triplet_loss(_t(a), _t(p), _t(n), 0.1,
                                   mask=None if mask is None else _t(mask),
                                   normalize=normalize))
    assert want > 0.0
    assert abs(got - want) <= 1e-6
    np.testing.assert_allclose(tloss.l2_normalize(_t(a)).numpy(),
                               np.asarray(jloss.l2_normalize(a)), atol=1e-6)


# ---------------- miner ----------------

def _mining_data(n=150, seed=2):
    """Two-lap loop (positives: the other lap), jittered so no distance
    sits on a threshold; random histograms (untied W₁)."""
    rng = np.random.default_rng(seed)
    poses = loop_trajectory(n, radius=60.0, loops=2.0)
    poses[:, :2, 3] += rng.normal(0, 0.7, (n, 2))
    desc = rng.random((n, 40)).astype(np.float32) ** 3
    positions = poses[:, :3, 3].astype(np.float32)
    cdfs = np.cumsum(desc / np.maximum(desc.sum(1, keepdims=True), 1e-12),
                     axis=1).astype(np.float32)
    return positions, cdfs, desc, poses


def _masks(positions):
    """The miner's positive and negative masks, numpy float32."""
    n = len(positions)
    d = np.sqrt((((positions[:, None, :] - positions[None, :, :]) ** 2)
                 .sum(-1)).astype(np.float32))
    gap = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    pos = (d < PARAMS[0]) & (gap >= PARAMS[1]) & (gap > 0)
    neg = (d >= PARAMS[2]) & (d <= PARAMS[3]) & (gap >= PARAMS[4]) & (gap > 0)
    return pos, neg


@pytest.mark.parametrize("strategy", ["hard", "semi-hard"])
def test_mined_negatives_equal_jax(strategy, monkeypatch):
    """Hard and semi-hard negatives and ``valid`` are identical to JAX's
    on untied random histograms; 150 anchors in chunks of 64 (chunk
    boundaries crossed) and, for the port, W₁ tiles of 32 rows (the
    running min crosses tiles). Each hard negative's W₁ is within 1e-6
    of the least W₁ over the anchor's negatives; positives fall inside the
    positive mask."""
    monkeypatch.setattr(tminer, "TILE", 32)
    positions, cdfs, _, _ = _mining_data()
    jp, jn, jv = jminer._mine_kernel_chunked(
        positions, cdfs, jax.random.key(0), PARAMS, strategy, chunk=64)
    gen = torch.Generator().manual_seed(0)
    tp, tn, tv = tminer._mine_kernel_chunked(
        _t(positions), _t(cdfs), gen, tuple(float(v) for v in PARAMS),
        strategy, chunk=64)
    pos, neg = _masks(positions)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tv, pos.any(1) & neg.any(1))
    assert tv.sum() > 50
    np.testing.assert_array_equal(tn, jn)
    rows = np.nonzero(tv)[0]
    assert pos[rows, tp[rows]].all()
    if strategy == "hard":
        w1 = np.abs(cdfs[:, None, :].astype(np.float64)
                    - cdfs[None, :, :]).sum(-1)
        best = np.where(neg, w1, np.inf).min(1)
        assert np.all(w1[rows, tn[rows]] - best[rows] <= 1e-6)


def test_random_strategy_draws_inside_jax_masks():
    """Random negatives and all positives fall inside the masks JAX's
    draws are taken from; ``valid`` identical."""
    positions, cdfs, _, _ = _mining_data(seed=3)
    _, _, jv = jminer._mine_kernel_chunked(
        positions, cdfs, jax.random.key(1), PARAMS, "random", chunk=64)
    tp, tn, tv = tminer._mine_kernel_chunked(
        _t(positions), _t(cdfs), torch.Generator().manual_seed(1),
        tuple(float(v) for v in PARAMS), "random", chunk=64)
    pos, neg = _masks(positions)
    np.testing.assert_array_equal(tv, jv)
    rows = np.nonzero(tv)[0]
    assert pos[rows, tp[rows]].all() and neg[rows, tn[rows]].all()
    assert len(np.unique(tn[rows])) > 5          # draws, not one index


def test_mine_triplets_keeps_sequences_apart():
    """Two sequences of 150 frames with overlapping positions: every
    triplet stays inside one sequence, and the anchors and hard negatives
    are JAX's (``TripletMiner.mine_triplets`` with ``sequence_ids``)."""
    p1, _, d1, poses1 = _mining_data(seed=4)
    _, _, d2, poses2 = _mining_data(seed=5)
    desc = np.concatenate([d1, d2])
    poses = np.concatenate([poses1, poses2])
    seq = np.repeat([3, 7], len(d1))
    want = jminer.TripletMiner(seed=0).mine_triplets(desc, poses,
                                                     sequence_ids=seq)
    got = tminer.TripletMiner(seed=0, device="cpu").mine_triplets(
        desc, poses, sequence_ids=seq)
    assert got.dtype == np.int64 and got.shape[1] == 3 and len(got) > 100
    assert np.all(seq[got] == seq[got[:, :1]])
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_array_equal(got[:, 2], want[:, 2])


@pytest.mark.parametrize("strategy", ["hard", "semi-hard", "random"])
def test_batch_triplet_miner_matches_jax(strategy):
    """In-batch miner, numpy on both sides: identical triplets."""
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(40, 8)).astype(np.float32)
    labels = rng.integers(0, 6, 40)
    want = jminer.BatchTripletMiner(margin=0.5, mining_strategy=strategy,
                                    seed=3).mine_batch_triplets(emb, labels)
    got = tminer.BatchTripletMiner(margin=0.5, mining_strategy=strategy,
                                   seed=3).mine_batch_triplets(emb, labels)
    assert len(got[0]) > 30
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------- validation ----------------

def _loop_positions(n=100, seed=7):
    rng = np.random.default_rng(seed)
    poses = loop_trajectory(n, radius=60.0, loops=2.0)
    poses[:, :2, 3] += rng.normal(0, 1.0, (n, 2))
    return poses


@pytest.mark.parametrize("row_chunk", [16, 2048])
def test_find_revisit_queries_matches_jax(row_chunk):
    """Identical (query, revisited) pairs, chunked and unchunked."""
    poses = _loop_positions()
    pos = poses[:, :3, 3].astype(np.float32)
    want = jval.find_revisit_queries(pos, 5.0, 30, row_chunk=row_chunk)
    got = tval.find_revisit_queries(pos, 5.0, 30, row_chunk=row_chunk,
                                     device="cpu")
    assert len(want) > 20
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("query_chunk", [7, 4096])
def test_recall_matches_jax(query_chunk):
    """Recall@{1,5} within 1e-7 of JAX, queries in chunks of 7 and in
    one chunk; the same query count."""
    poses = _loop_positions(seed=8)
    rng = np.random.default_rng(8)
    emb = (poses[:, :3, 3] / 30 + rng.normal(0, 1.0, (len(poses), 3)))
    emb = np.concatenate([emb, rng.normal(size=(len(poses), 13))], 1)
    emb = emb.astype(np.float32)
    for k in (1, 5):
        want, nq_w = jval.recall_loop_closure(emb, poses, k)
        got, nq = tval.recall_loop_closure(emb, poses, k,
                                           query_chunk=query_chunk,
                                           device="cpu")
        assert nq == nq_w > 20
        assert 0.0 < want < 1.0
        assert abs(got - want) <= 1e-7


# ---------------- train step and optimizer ----------------

N_NODES = 64


def _train_setup(seed=9):
    """Full-width model (dropout 0) with init_gnn parameters, a 64-node
    graph with loop edges, 200 triplets padded to 256 with a mask."""
    rng = np.random.default_rng(seed)
    poses = loop_trajectory(N_NODES, radius=40.0, loops=2.0)
    desc = rng.random((N_NODES, 800)).astype(np.float32) ** 2
    desc /= desc.sum(1, keepdims=True)
    g = build_graph(desc, poses, loop_closures=[(0, 32), (5, 37), (9, 41)])
    model = JaxGNN(dropout=0.0)
    params, stats = init_gnn(model, jax.random.key(seed))
    trip = rng.integers(0, N_NODES, (256, 3))
    tmask = np.arange(256) < 200
    return model, params, stats, g, trip, tmask


def _jax_steps(model, opt, params, stats, g, trip, tmask, n_steps):
    state = opt.init(params)
    graph = [jnp.asarray(a) for a in g]
    out = []
    for _ in range(n_steps):
        params, stats, state, loss = jtrainer.train_step(
            model, opt, params, stats, state, *graph,
            jnp.asarray(trip[:, 0]), jnp.asarray(trip[:, 1]),
            jnp.asarray(trip[:, 2]), jnp.asarray(tmask), 0.1,
            jax.random.key(0))
        out.append((float(loss), params, stats, state))
    return out


def _torch_net(params, stats):
    net = SpectralGNN(dropout=0.0)
    net.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params),
                                  jax.tree_util.tree_map(np.asarray, stats)))
    return net


# The biases the loss cannot see (``gauge_parameters``): each framework
# returns rounding noise for their gradient (up to 2e-3 here), which Adam
# turns into steps of ±lr of either sign, so the two sides differ there
# by up to 2·lr per step. They are held through what they feed: the
# running means below them, with the biases' own contribution removed.
GAUGE = gauge_parameters(SpectralGNN())
BIAS_OF_BN = {"input_bn": "input_proj.bias",
              **{f"gat_bns.{i}": f"gat_layers.{i}.bias" for i in range(3)}}


def _state(params, stats):
    return from_flax(jax.tree_util.tree_map(np.asarray, params),
                     jax.tree_util.tree_map(np.asarray, stats))


def _debiased(state, biases):
    """Running means without their gauge biases: after T train steps
    rm = 0.9ᵀ·rm₀ + 0.1·Σₜ 0.9ᵀ⁻¹⁻ᵗ (mᵗ + bₜ), where bₜ is the bias the
    t-th forward used; subtract the b terms."""
    out = dict(state)
    T = len(biases)
    for bn, bias in BIAS_OF_BN.items():
        out[f"{bn}.running_mean"] = state[f"{bn}.running_mean"] - 0.1 * sum(
            0.9 ** (T - 1 - t) * b[bias] for t, b in enumerate(biases))
    return out


def _assert_state_close(got, want, tol):
    """Every parameter and statistic but the gauge biases within ``tol``."""
    for name, w in want.items():
        if name.endswith("num_batches_tracked") or name in GAUGE:
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=tol, err_msg=name)


def _biases(state):
    return {k: state[k].clone() for k in GAUGE}


@pytest.mark.parametrize("clip", [1e-3, 1e4], ids=["clip-active",
                                                   "clip-inactive"])
def test_train_step_matches_jax(clip):
    """One and three full-width train steps (64 nodes, dropout 0, the same
    triplets, lr 1e-4, weight decay 1e-5) from ``init_gnn`` parameters,
    against JAX's ``train_step``. The clip is active (global norm above
    1e-3) or inactive (below 1e4). Bars: loss within 1e-5·max(1, |loss|)
    (the loss is ~270: float32 sums of 200 triplets); each gradient tensor
    before the clip within 1e-5·max(1, its largest entry); parameters and
    BatchNorm statistics within 1e-5, the gauge biases (``GAUGE``) held
    through the running means they feed and their gradients being noise
    (below 1e-3 of the largest gradient entry on both sides).

    Why lr 1e-4, not the configured 5e-4: Adam divides each update by the
    element's √v̂, so where an element's gradient is near the float32
    rounding of the sum (about 1e-6 of the tensor's largest entry) the two
    frameworks' updates differ, and the difference feeds the next steps.
    Without the clip, after three steps at 5e-4 a few weights end up to
    3.8e-5 apart (3 of 204,800 input-projection weights above 1e-5); at
    1e-4 every parameter is within 3.3e-7."""
    model, params, stats, g, trip, tmask = _train_setup()
    tol = 1e-5

    def loss_fn(p):
        emb, _ = model.apply({"params": p, "batch_stats": stats},
                             *[jnp.asarray(a) for a in g], train=True,
                             mutable=["batch_stats"])
        return jloss.triplet_loss(emb[trip[:, 0]], emb[trip[:, 1]],
                                  emb[trip[:, 2]], 0.1,
                                  mask=jnp.asarray(tmask))

    jgrads = jax.grad(loss_fn)(params)
    norm = float(optax.global_norm(jgrads))
    assert (norm > clip) == (clip < 1.0)

    net = _torch_net(params, stats)
    graph = graph_to_tensors(g, "cpu")
    a, p, n = (_t(trip[:, i]) for i in range(3))
    net.train()
    emb = net(graph.features, graph.neighbors, graph.mask, graph.edge_feats)
    tloss.triplet_loss(emb[a], emb[p], emb[n], 0.1, mask=_t(tmask)).backward()
    want_g = from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    top = max(float(v.abs().max()) for v in want_g.values())
    for name, prm in net.named_parameters():
        got, want = prm.grad.numpy(), want_g[name].numpy()
        if name in GAUGE:
            assert max(np.abs(got).max(), np.abs(want).max()) < 1e-3 * top
            continue
        np.testing.assert_allclose(
            got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()),
            err_msg=name)

    opt_j = jtrainer.make_optimizer(1e-4, 1e-5, clip)
    steps = _jax_steps(model, opt_j, params, stats, g, trip, tmask, 3)
    jax_biases = [_biases(_state(params, stats))] + [
        _biases(_state(jp, js)) for _, jp, js, _ in steps[:2]]
    net = _torch_net(params, stats)
    opt = make_optimizer(net, 1e-4, 1e-5)
    biases = []
    for i in range(3):
        biases.append(_biases(net.state_dict()))
        loss = train_step(net, opt, graph, a, p, n, _t(tmask), 0.1,
                          grad_clip=clip)
        want_loss, jp, js, _ = steps[i]
        assert abs(float(loss) - want_loss) <= tol * max(1.0, abs(want_loss))
        if i in (0, 2):
            _assert_state_close(
                _debiased(net.state_dict(), biases),
                _debiased(_state(jp, js), jax_biases[:i + 1]), tol)


def _adam_state(opt_state):
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return next(s for s in leaves if isinstance(s, optax.ScaleByAdamState))


def test_from_optax_adam_continues_jax_training():
    """Two JAX steps, then the parameters, batch statistics and optax Adam
    state converted (``from_flax``, ``from_optax_adam``), then one more
    step on each side: parameters and statistics within 1e-5 (the gauge
    biases aside: see ``GAUGE``; both sides start the step from the same
    biases, so the running means need no correction)."""
    model, params, stats, g, trip, tmask = _train_setup(seed=10)
    opt_j = jtrainer.make_optimizer(5e-4, 1e-5, 1.0)
    steps = _jax_steps(model, opt_j, params, stats, g, trip, tmask, 3)
    _, p2, s2, st2 = steps[1]
    _, p3, s3, _ = steps[2]
    adam = _adam_state(st2)
    net = _torch_net(p2, s2)
    opt = make_optimizer(net, 5e-4, 1e-5)
    opt.load_state_dict(from_optax_adam(
        np.asarray(adam.count), jax.tree_util.tree_map(np.asarray, adam.mu),
        jax.tree_util.tree_map(np.asarray, adam.nu), net, opt))
    assert int(opt.state_dict()["state"][0]["step"]) == 2
    graph = graph_to_tensors(g, "cpu")
    train_step(net, opt, graph, *(_t(trip[:, i]) for i in range(3)),
               _t(tmask), 0.1, grad_clip=1.0)
    _assert_state_close(net.state_dict(), _state(p3, s3), 1e-5)


# ---------------- trainer ----------------

def _toy_task(rng, n=120, d=32):
    """Descriptors that carry a noisy place signal on a two-lap loop
    (``tests/test_training.py:150``)."""
    poses = loop_trajectory(n, radius=80.0, loops=2.0)
    angle = np.arctan2(poses[:, 1, 3], poses[:, 0, 3])
    place = np.stack([np.cos(angle * f) for f in range(1, d + 1)], axis=1)
    desc = np.abs(place + rng.normal(0, 0.3, (n, d))).astype(np.float32)
    desc /= desc.sum(1, keepdims=True)
    return desc, poses, build_graph(desc, poses, temporal_neighbors=5)


def _small_net(d=32):
    return SpectralGNN(input_dim=d, hidden_dim=16, output_dim=d, n_layers=3,
                       edge_dim=2, dropout=0.0)


def test_trainer_training_improves(tmp_path):
    """Ten epochs on the toy task: the loss falls below half its first
    value and Recall@5 exceeds 0.2 (as the JAX trainer's test)."""
    desc, poses, graph = _toy_task(np.random.default_rng(11))
    tr = GNNTrainer(model=_small_net(), checkpoint_dir=str(tmp_path),
                    triplets_per_step=256, learning_rate=1e-3, device="cpu")
    miner = tminer.TripletMiner(seed=1, device="cpu")
    losses = []
    for epoch in range(10):
        tr.epoch = epoch
        losses.append(tr.train_epoch(graph, miner, poses, desc))
    assert losses[-1] < 0.5 * losses[0]
    m = tr.validate(graph, poses)
    assert m["n_queries"] > 0 and m["recall@5"] > 0.2


def test_trainer_checkpoint_roundtrip(tmp_path):
    """save_checkpoint → load_checkpoint in a fresh trainer: the same
    model and optimizer state, counters and embeddings (exact)."""
    desc, poses, graph = _toy_task(np.random.default_rng(12), n=60, d=16)
    tr = GNNTrainer(model=SpectralGNN(16, 8, 16, n_layers=2, dropout=0.0),
                    checkpoint_dir=str(tmp_path), triplets_per_step=128,
                    device="cpu")
    tr.train_epoch(graph, tminer.TripletMiner(device="cpu"), poses, desc)
    tr.best_val_metric, tr.global_step = 0.5, 7
    tr.save_checkpoint("best_model")
    assert (tmp_path / "best_model.pt").exists()
    tr2 = GNNTrainer(model=SpectralGNN(16, 8, 16, n_layers=2, dropout=0.0),
                     checkpoint_dir=str(tmp_path), triplets_per_step=128,
                     seed=5, device="cpu")
    tr2.load_checkpoint("best_model")
    assert (tr2.global_step, tr2.best_val_metric) == (7, 0.5)
    assert tr2.train_losses == tr.train_losses
    for k, v in tr.model.state_dict().items():
        assert torch.equal(tr2.model.state_dict()[k], v), k
    s1, s2 = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
    for i, st in s1["state"].items():
        for k, v in st.items():
            assert torch.equal(s2["state"][i][k], v), (i, k)
    np.testing.assert_array_equal(tr.embed(graph), tr2.embed(graph))
    with pytest.raises(FileNotFoundError):
        tr2.load_checkpoint("missing")


def test_trainer_lr_decay_and_metrics_jsonl(tmp_path):
    """``train`` with step decay at epochs 1 and 2 (factor 0.1, floor
    1e-5): the optimizer's learning rate per epoch is 1e-3, 1e-4, 1e-5;
    ``metrics.jsonl`` holds one training record (loss, lr, seconds) and
    one validation record per epoch; final_model.pt is written."""
    desc, poses, graph = _toy_task(np.random.default_rng(13), n=80, d=16)
    tr = GNNTrainer(model=SpectralGNN(16, 8, 16, n_layers=2, dropout=0.0),
                    checkpoint_dir=str(tmp_path), triplets_per_step=128,
                    learning_rate=1e-3, lr_decay_epochs=[1, 2],
                    lr_decay_factor=0.1, min_lr=1e-5, device="cpu")
    tr.train(graph, poses, desc, val_graph=graph, val_poses=poses,
             n_epochs=3, save_every_epochs=0)
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(1e-5)
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    train_recs = [r for r in recs if "train_loss" in r]
    assert [r["epoch"] for r in train_recs] == [0, 1, 2]
    np.testing.assert_allclose([r["lr"] for r in train_recs],
                               [1e-3, 1e-4, 1e-5])
    assert all(np.isfinite(r["train_loss"]) and r["epoch_seconds"] > 0
               for r in train_recs)
    assert sum("recall@1" in r for r in recs) == 3
    assert (tmp_path / "final_model.pt").exists()
