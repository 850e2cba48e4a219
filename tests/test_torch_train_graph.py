"""Kernel G (``csrc/gather_bwd.cu``, ``models/gather_kernel.py``) and the
training graph families on the CPU, where each executable runs its step
eagerly (``utils/graph_exec.GraphStep``): G's plain version and a numpy
model of the kernel's schedule against the CPU's ``index_add_`` bit for
bit, the gathers' autograd, the train step
executable against JAX's ``train_step``, seeded runs, the learning-rate
tensor, checkpoints and ``from_optax_adam`` with the executable, the
revisit and recall executables against JAX (the last chunk overlapped or
padded, ties at the k-th place), and the embedding pass.

The kernels and graphs run only on a card (``chip_smoke.py`` phase 7
holds G against its plain version and each graph against its eager step
there, bit for bit). Small shapes: 2-layer narrow GNNs, or the full-width
one on 64 nodes where JAX's step is the reference."""

import copy
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402

import test_torch_training as ttt  # noqa: E402
from neural_spectral_codec_tpu.data.synthetic import (  # noqa: E402
    loop_trajectory)
from neural_spectral_codec_tpu.training import (  # noqa: E402
    trainer as jtrainer, validation as jval)
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: E402
    build_graph, graph_to_tensors)
from neural_spectral_codec_torch.models import SpectralGNN, gnn  # noqa: E402
from neural_spectral_codec_torch.models import (  # noqa: E402
    gather_kernel as gk)
from neural_spectral_codec_torch.models.convert import (  # noqa: E402
    from_optax_adam)
from neural_spectral_codec_torch.training import (  # noqa: E402
    miner as tminer, trainer as ttrainer, validation as tval)
from neural_spectral_codec_torch.training.trainer import (  # noqa: E402
    GNNTrainer, TrainStepExecutable, make_optimizer, train_step)
from neural_spectral_codec_torch.utils.graph_exec import (  # noqa: E402
    SharedPool)

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------- kernel G's plain version ----------------

def _index(case, rng):
    if case == "repeated":            # every row many times, shuffled
        return rng.permutation(np.repeat(np.arange(9), 7))
    if case == "unsorted":
        return rng.integers(0, 40, 300)
    if case == "empty-segments":      # rows 0-19 of 30, half never hit
        return rng.choice(np.arange(0, 20, 2), 120)
    return np.array([3])              # "single-row"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["repeated", "unsorted", "empty-segments",
                                  "single-row"])
def test_gather_bwd_plain_equals_index_add(case, dtype):
    """``gather_bwd_plain`` equals the CPU's sequential ``index_add_`` into
    zeros bit for bit, float32 and bf16 (summed in float32, rounded once),
    on repeated, unsorted and single indices and rows that no position
    gathers (+0). Gradients span 6 decades, so the order of the adds
    shows."""
    rng = np.random.default_rng(1)
    idx = _t(_index(case, rng))
    n = {"repeated": 9, "unsorted": 40, "empty-segments": 30,
         "single-row": 5}[case]
    grad = (_t(rng.normal(size=(len(idx), 33)) * 10.0 ** rng.integers(
        -3, 3, (len(idx), 1)))).to(dtype)
    plan = gk.make_plan(idx, n)
    got = gk.gather_bwd_plain(grad, plan, n)
    want = torch.zeros(n, 33, dtype=dtype).index_add_(0, idx, grad)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
    assert torch.equal(gk.gather_bwd(grad, plan, n), got)


def test_plan_segments_and_left_out_positions():
    """``make_plan``: positions stably sorted by row, segment starts by
    row, positions with ``valid`` off in no segment; summing a gradient
    that is 0 at those positions gives ``index_add_`` over all of them."""
    idx = _t(np.array([4, 1, 4, 0, 1, 4, 2]))
    valid = _t(np.array([True, True, False, True, True, True, False]))
    plan = gk.make_plan(idx, 6, valid)
    assert plan.order.dtype == torch.int32 and plan.offsets.dtype == \
        torch.int32
    assert plan.offsets.tolist() == [0, 1, 3, 3, 3, 5, 5]
    assert plan.order[:5].tolist() == [3, 1, 4, 0, 5]
    grad = torch.randn(7, 5) * valid[:, None]
    assert torch.equal(gk.gather_bwd_plain(grad, plan, 6),
                       torch.zeros(6, 5).index_add_(0, idx, grad))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_gradient_equals_index_select(dtype):
    """``gather_rows``' forward is ``index_select`` and its gradient
    (kernel G's plain version on the CPU) equals ``index_select``'s
    (``index_add_``) bit for bit."""
    rng = np.random.default_rng(2)
    src = _t(rng.normal(size=(50, 16))).to(dtype)
    idx = _t(rng.integers(0, 50, 400))
    w = _t(rng.normal(size=(400, 16))).to(dtype)
    grads = []
    for fn in (gk.gather_rows, lambda s, i: s.index_select(0, i)):
        s = src.clone().requires_grad_(True)
        out = fn(s, idx)
        (out * w).sum().backward()
        grads.append((out.detach(), s.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    with torch.no_grad():
        assert torch.equal(gk.gather_rows(src, idx), src[idx])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_attend_backward_through_g_equals_index_add(dtype, monkeypatch):
    """A GAT layer's backward with the neighbour gather through G over
    the valid slots' plan equals the same backward through
    ``index_select`` (``index_add_`` over every slot, the padded ones
    included) bit for bit, in float32 and bf16 compute: the masked slots'
    gradient is ±0."""
    rng = np.random.default_rng(3)
    poses = loop_trajectory(60, radius=20.0, loops=2.0)
    g = build_graph(rng.random((60, 16)).astype(np.float32), poses,
                    loop_closures=[(0, 30), (4, 34)])
    assert not g.mask.all()
    layer = gnn.EdgeGATLayer(16, 16, 2, compute_dtype=dtype)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    t = graph_to_tensors(g, "cpu")
    x = _t(rng.normal(size=(60, 16)).astype(np.float32))
    w = _t(rng.normal(size=(60, 16)).astype(np.float32))
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(gnn, "gather_rows",
                                lambda s, i, plan=None, valid=None:
                                s.index_select(0, i))
        xi = x.clone().requires_grad_(True)
        out, _ = layer(xi, t.neighbors, t.mask, t.edge_feats)
        (out.float() * w).sum().backward()
        grads.append(xi.grad)
    assert torch.equal(grads[0], grads[1])


def test_neighbour_table_holds_the_valid_slots_only():
    """The GAT's table (``make_plan`` with the mask as ``valid``) leaves
    the masked slots out of every segment, each row's positions in
    increasing order."""
    nb = _t(np.array([[1, 0], [0, 0], [1, 2]]))
    mask = _t(np.array([[True, False], [True, False], [True, True]]))
    plan = gk.make_plan(nb.reshape(-1), 3, mask.reshape(-1))
    assert plan.offsets.tolist() == [0, 1, 3, 4]
    assert plan.order[:4].tolist() == [2, 0, 4, 5]


def _g_constants() -> dict:
    """The ``constexpr int kName = <literal>;`` lines of csrc/gather_bwd.cu."""
    text = (REPO / "neural_spectral_codec_torch" / "csrc" /
            "gather_bwd.cu").read_text()
    return {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}


def g_model(grad, plan, n_rows, warps, width=4):
    """Kernel G as ``csrc/gather_bwd.cu`` orders its work, in numpy: items
    (row, slice of 32 chunks of ``width`` columns), warp w taking the items
    w, w + warps, ... 32 at a time; a batch's empty items written as zeros,
    then its other items' (item, position) pairs as one list, the items
    with more than kDepth positions first, each lane's item and position
    found from the prefix sums and ``at`` as the kernel finds them, summed
    in float32 in list order, each item written when the list moves on.
    Returns (out, writes): the (n_rows, C) sums rounded once to grad's type
    and the number of times each (row, slice) was written."""
    depth = _g_constants()["kDepth"]
    order, offsets = plan.order.numpy(), plan.offsets.numpy()
    g = grad.float().numpy()
    n_cols = g.shape[1]
    chunks = n_cols // width
    slices = -(-chunks // 32)
    items = n_rows * slices
    out = np.full((n_rows, n_cols), np.nan, np.float32)
    writes = np.zeros((n_rows, slices), np.int64)
    lanes = np.arange(32)

    def write(r, c, acc):
        cols = slice(c * width, min((c + 32) * width, n_cols))
        out[r, cols] = acc[:cols.stop - cols.start]
        writes[r, c // 32] += 1

    for w in range(warps):
        for base in range(w, items, 32 * warps):
            mine = base + lanes * warps
            ok = mine < items
            row = np.where(ok, mine // slices, 0)
            col = np.where(ok, (mine - row * slices) * 32, 0)
            lo = np.where(ok, offsets[row], 0)
            ln = np.where(ok, offsets[row + 1] - lo, 0)
            for l in np.flatnonzero(ok & (ln == 0)):
                write(row[l], col[l], np.zeros(32 * width, np.float32))
            longer = ln > depth
            x = np.cumsum(np.where(longer, ln, 0))
            y = np.cumsum(np.where(longer, 0, ln))
            total = x[31] + y[31]
            end = np.where(longer, x, x[31] + y)
            begin = end - ln
            cur, acc = -1, None
            for f0 in range(0, total, 32):
                f = f0 + lanes
                own = np.zeros(32, np.int64)
                for l in np.flatnonzero((ln > 0) & (begin < f0 + 32)
                                        & (end > f0)):
                    own = np.where((f >= begin[l]) & (f < end[l]), l, own)
                at = lo[own] + f - begin[own]
                p = np.where(f < total, order[np.minimum(at, len(order) - 1)],
                             0)
                for k in range(min(32, total - f0)):
                    if own[k] != cur:
                        if cur >= 0:
                            write(row[cur], col[cur], acc)
                        cur = own[k]
                        acc = np.zeros(32 * width, np.float32)
                    c0 = col[cur] * width
                    part = g[p[k], c0:c0 + 32 * width]
                    acc[:len(part)] = acc[:len(part)] + part
            if cur >= 0:
                write(row[cur], col[cur], acc)
    return torch.from_numpy(out).to(grad.dtype), writes


def _g_plan(case, rng):
    """(index, n_rows): a neighbour table of in-degree ~4, a triplet
    column of 600 into 2,000 rows with one row gathered 300 times, or
    rows every one of which is gathered."""
    if case == "neighbours":
        return rng.integers(0, 300, 1200), 300
    if case == "long-segment":
        idx = rng.integers(0, 2000, 600)
        idx[rng.permutation(600)[:300]] = 1234
        return idx, 2000
    return rng.permutation(np.repeat(np.arange(150), 3)), 150


@pytest.mark.parametrize("warps", [1, 5, 64])
@pytest.mark.parametrize("case", ["neighbours", "long-segment", "full"])
def test_g_model_covers_each_item_once_and_equals_index_add(case, warps):
    """The model of G's schedule writes every (row, slice) exactly once,
    whatever the number of warps, and its sums equal the CPU's
    ``index_add_`` bit for bit, float32 (300 columns: 3 slices of 128
    float32, the last one 44 wide) and bf16 (256 columns at 8 a chunk: 1
    slice), on a neighbour-like table, a plan with a 300-position segment
    and one with no empty row."""
    rng = np.random.default_rng(31)
    idx, n = _g_plan(case, rng)
    plan = gk.make_plan(_t(idx), n)
    for dtype, n_cols, width in ((torch.float32, 300, 4),
                                 (torch.bfloat16, 256, 8)):
        grad = (_t(rng.normal(size=(len(idx), n_cols)) * 10.0 **
                   rng.integers(-3, 3, (len(idx), 1)))).to(dtype)
        got, writes = g_model(grad, plan, n, warps, width)
        assert (writes == 1).all()
        want = torch.zeros(n, n_cols, dtype=dtype).index_add_(0, _t(idx),
                                                              grad)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_bwd_plain_long_segment_equals_index_add(dtype):
    """A plan with a 300-position segment on one row (and 300 positions
    elsewhere): ``gather_bwd_plain`` equals the CPU's ``index_add_`` into
    zeros bit for bit."""
    rng = np.random.default_rng(32)
    idx, n = _g_plan("long-segment", rng)
    plan = gk.make_plan(_t(idx), n)
    seg = plan.offsets[1:] - plan.offsets[:-1]
    assert int(seg.max()) >= 300
    grad = _t(rng.normal(size=(len(idx), 80)).astype(np.float32)).to(dtype)
    assert torch.equal(gk.gather_bwd_plain(grad, plan, n),
                       torch.zeros(n, 80, dtype=dtype).index_add_(
                           0, _t(idx), grad))


# ---------------- the train step executable ----------------

def _exe_for(net, opt, g, batch, clip, generator=None):
    exe = TrainStepExecutable(net, opt, g.n_nodes, g.max_degree,
                              g.edge_feats.shape[2], batch, 0.1, clip, False,
                              generator, torch.device("cpu"))
    exe.load_graph(g)
    return exe


@pytest.mark.parametrize("clip", [1e-3, 1e4], ids=["clip-active",
                                                   "clip-inactive"])
def test_train_step_executable_matches_jax(clip):
    """Three steps of ``TrainStepExecutable`` (its CPU path: the eager
    ``GraphStep``) against JAX's ``train_step``, at the bar of
    ``test_torch_training.test_train_step_matches_jax``: loss within
    1e-5·max(1, |loss|), parameters and BatchNorm statistics within 1e-5,
    the gauge biases held through the running means they feed."""
    model, params, stats, g, trip, tmask = ttt._train_setup()
    steps = ttt._jax_steps(model, jtrainer.make_optimizer(1e-4, 1e-5, clip),
                           params, stats, g, trip, tmask, 3)
    jax_biases = [ttt._biases(ttt._state(params, stats))] + [
        ttt._biases(ttt._state(jp, js)) for _, jp, js, _ in steps[:2]]
    net = ttt._torch_net(params, stats)
    opt = make_optimizer(net, 1e-4, 1e-5)
    exe = _exe_for(net, opt, g, 256, clip)
    before = dict(ttrainer.STATS)
    biases = []
    for i in range(3):
        biases.append(ttt._biases(net.state_dict()))
        out, captured = exe.run({"triplets": trip, "tmask": tmask})
        want_loss, jp, js, _ = steps[i]
        assert not captured
        assert abs(float(out["loss"]) - want_loss) <= 1e-5 * max(
            1.0, abs(want_loss))
        if i in (0, 2):
            ttt._assert_state_close(
                ttt._debiased(net.state_dict(), biases),
                ttt._debiased(ttt._state(jp, js), jax_biases[:i + 1]), 1e-5)
    assert ttrainer.STATS["eager_steps"] - before["eager_steps"] == 3


def _toy(seed=12, n=80, d=16):
    desc, poses, graph = ttt._toy_task(np.random.default_rng(seed), n=n, d=d)
    return desc, poses, graph


def _trainer(tmp, seed=0, dropout=0.1, **kw):
    return GNNTrainer(model=SpectralGNN(16, 8, 16, n_layers=2,
                                        dropout=dropout),
                      checkpoint_dir=str(tmp), triplets_per_step=128,
                      seed=seed, device="cpu", **kw)


def test_two_seeded_runs_give_the_same_bits(tmp_path):
    """Two trainers from one seed (dropout 0.1, drawn from the trainer's
    generator), two epochs each with a seeded miner: the same losses,
    parameters, buffers and Adam state, bit for bit."""
    desc, poses, graph = _toy()
    runs = []
    for k in range(2):
        tr = _trainer(tmp_path / str(k))
        miner = tminer.TripletMiner(seed=1, device="cpu")
        losses = [tr.train_epoch(graph, miner, poses, desc) for _ in range(2)]
        runs.append((losses, tr))
    assert runs[0][0] == runs[1][0] and runs[0][0][0] > 0
    a, b = runs[0][1], runs[1][1]
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_executable_reads_the_decayed_learning_rate(tmp_path):
    """``set_learning_rate`` writes the optimizer's learning-rate tensor
    in place (the same tensor every param group holds), and the next
    executable step equals the module-level ``train_step`` run on a copy
    of the model and optimizer, bit for bit."""
    desc, poses, graph = _toy()
    tr = _trainer(tmp_path, dropout=0.0)
    miner = tminer.TripletMiner(seed=1, device="cpu")
    tr.train_epoch(graph, miner, poses, desc)
    lr = tr.optimizer.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and lr.dim() == 0
    tr.set_learning_rate(1e-5)
    assert tr.optimizer.param_groups[0]["lr"] is lr
    assert float(lr) == float(np.float32(1e-5))
    model, opt = copy.deepcopy((tr.model, tr.optimizer))
    trip = np.stack([np.arange(40), (np.arange(40) + 40) % 80,
                     (np.arange(40) + 20) % 80], 1)
    tmask = np.ones(128, bool)
    tmask[40:] = False
    batch = np.zeros((128, 3), np.int64)
    batch[:40] = trip
    exe = tr.train_step_executable(graph, 128)
    out, _ = exe.run({"triplets": batch, "tmask": tmask})
    b = _t(batch)
    want = train_step(model, opt, graph_to_tensors(graph, "cpu"), b[:, 0],
                      b[:, 1], b[:, 2], _t(tmask), tr.margin,
                      grad_clip=tr.grad_clip)
    assert float(out["loss"]) == float(want)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_checkpoint_round_trip_continues_identically(tmp_path):
    """A checkpoint loaded into a fresh trainer (which drops its train
    executable and writes the loaded learning rate into its own tensor)
    continues one more epoch exactly as the trainer that saved it."""
    desc, poses, graph = _toy()
    tr = _trainer(tmp_path / "a", dropout=0.0)
    miner = tminer.TripletMiner(seed=1, device="cpu")
    tr.train_epoch(graph, miner, poses, desc)
    tr.set_learning_rate(2e-4)
    tr.save_checkpoint("mid")
    tr2 = _trainer(tmp_path / "a", seed=5, dropout=0.0)
    tr2.train_epoch(graph, tminer.TripletMiner(seed=2, device="cpu"), poses,
                    desc)          # a graph of its own, dropped on load
    tr2.load_checkpoint("mid")
    assert tr2._train_exe is None
    assert tr2.optimizer.param_groups[0]["lr"] is tr2._lr
    assert float(tr2._lr) == float(np.float32(2e-4))
    l1 = tr.train_epoch(graph, tminer.TripletMiner(seed=3, device="cpu"),
                        poses, desc)
    l2 = tr2.train_epoch(graph, tminer.TripletMiner(seed=3, device="cpu"),
                         poses, desc)
    assert l1 == l2
    for k, v in tr.model.state_dict().items():
        assert torch.equal(tr2.model.state_dict()[k], v), k


def test_optimizer_state_of_another_form_loads(tmp_path):
    """An Adam state saved in another form (capturable and foreach, as a
    card's trainer saves it; a plain float learning rate, as
    ``convert_orbax_checkpoint.py`` writes it) loads into this trainer
    in its own form (``load_optimizer_state``): its capturable and
    foreach settings, step counts on the CPU, the learning rate in its
    tensor; one more epoch then equals the one after loading the state
    as saved."""
    desc, poses, graph = _toy()
    tr = _trainer(tmp_path / "a", dropout=0.0)
    tr.train_epoch(graph, tminer.TripletMiner(seed=1, device="cpu"), poses,
                   desc)
    saved = copy.deepcopy(tr.optimizer.state_dict())
    other = copy.deepcopy(saved)
    for g in other["param_groups"]:
        g.update(capturable=True, foreach=True, lr=3e-4)
    runs = []
    for state in (saved, other):
        t = _trainer(tmp_path / "b", seed=5, dropout=0.0)
        t.model.load_state_dict(tr.model.state_dict())
        t.load_optimizer_state(state)
        g0 = t.optimizer.param_groups[0]
        assert (g0["capturable"], g0["foreach"]) == (False, False)
        assert g0["lr"] is t._lr and torch.is_tensor(t._lr)
        assert all(st["step"].device.type == "cpu"
                   for st in t.optimizer.state.values())
        t.set_learning_rate(3e-4)
        runs.append((t.train_epoch(graph, tminer.TripletMiner(
            seed=2, device="cpu"), poses, desc), t))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].model.state_dict().items():
        assert torch.equal(runs[1][1].model.state_dict()[k], v), k


def test_from_optax_adam_continues_jax_training_through_the_executable():
    """Two JAX steps, the state converted (``from_flax``,
    ``from_optax_adam``), then one step on each side, the port's through
    ``TrainStepExecutable``: parameters and statistics within 1e-5 (the
    gauge biases aside)."""
    model, params, stats, g, trip, tmask = ttt._train_setup(seed=10)
    steps = ttt._jax_steps(model, jtrainer.make_optimizer(5e-4, 1e-5, 1.0),
                           params, stats, g, trip, tmask, 3)
    _, p2, s2, st2 = steps[1]
    _, p3, s3, _ = steps[2]
    adam = ttt._adam_state(st2)
    net = ttt._torch_net(p2, s2)
    opt = make_optimizer(net, 5e-4, 1e-5)
    opt.load_state_dict(from_optax_adam(
        np.asarray(adam.count), jax.tree_util.tree_map(np.asarray, adam.mu),
        jax.tree_util.tree_map(np.asarray, adam.nu), net, opt))
    assert int(opt.state_dict()["state"][0]["step"]) == 2
    exe = _exe_for(net, opt, g, 256, 1.0)
    exe.run({"triplets": trip, "tmask": tmask})
    ttt._assert_state_close(net.state_dict(), ttt._state(p3, s3), 1e-5)


def test_embed_runs_the_eval_executable(tmp_path):
    """``embed`` runs the eval step of the graph's own size (an
    ``EvalExecutable``, counted as its step), equal to the eager forward,
    and no declared eager forward."""
    desc, poses, graph = _toy()
    tr = _trainer(tmp_path, dropout=0.0)
    before = dict(gnn.STATS)
    emb = tr.embed(graph)
    tr.model.eval()
    want = gnn.gnn_forward(tr.model, graph_to_tensors(graph, "cpu")).numpy()
    np.testing.assert_array_equal(emb, want)
    assert gnn.STATS["eager_steps"] == before["eager_steps"] + 1
    assert gnn.STATS["eager_forwards"] == before["eager_forwards"]


# ---------------- validation ----------------

def _loop(n=100, seed=7):
    rng = np.random.default_rng(seed)
    poses = loop_trajectory(n, radius=60.0, loops=2.0)
    poses[:, :2, 3] += rng.normal(0, 1.0, (n, 2))
    return poses


@pytest.mark.parametrize("row_chunk", [16, 37, 100, 4096])
def test_revisit_executable_matches_jax(row_chunk):
    """The revisit scan through one ``RevisitExecutable`` (chunks of
    min(row_chunk, n) rows, the last moved back to end at n, its overlap
    dropped) gives JAX's (query, revisited) pairs."""
    pos = _loop()[:, :3, 3].astype(np.float32)
    want = jval.find_revisit_queries(pos, 5.0, 30, row_chunk=row_chunk)
    tval.clear_cache()
    got = tval.find_revisit_queries(pos, 5.0, 30, row_chunk=row_chunk,
                                    device="cpu")
    assert len(want) > 20
    np.testing.assert_array_equal(got, want)
    assert len(tval.cached_executables()) == 1


def _recall_input():
    poses = _loop(seed=8)
    rng = np.random.default_rng(8)
    emb = np.concatenate([poses[:, :3, 3] / 30 + rng.normal(
        0, 1.0, (100, 3)), rng.normal(size=(100, 13))], 1).astype(np.float32)
    return emb, poses


@pytest.mark.parametrize("query_chunk", [7, 13, 4096])
def test_recall_executable_matches_jax(query_chunk):
    """Recall@{1,5} through a ``RecallExecutable`` (the last chunk padded,
    its padding masked out) within 1e-7 of JAX."""
    emb, poses = _recall_input()
    for k in (1, 5):
        want, nq_w = jval.recall_loop_closure(emb, poses, k)
        got, nq = tval.recall_loop_closure(emb, poses, k,
                                           query_chunk=query_chunk,
                                           device="cpu")
        assert nq == nq_w > 20 and 0.0 < want < 1.0
        assert abs(got - want) <= 1e-7



@pytest.mark.parametrize("query_chunk", [7, 13, 4096])
def test_recall_at_ks_ranks_every_k_in_one_executable(query_chunk):
    """``recall_at_ks`` gives JAX's Recall@{1,5,10} (within 1e-7) from one
    ``RecallExecutable``, which ranks the largest k once."""
    emb, poses = _recall_input()
    tval.clear_cache()
    got, nq = tval.recall_at_ks(emb, poses, (5, 1, 10),
                                query_chunk=query_chunk, device="cpu")
    recall = [e for e in tval.cached_executables()
              if isinstance(e, tval.RecallExecutable)]
    assert len(recall) == 1 and recall[0].ks == (1, 5, 10)
    assert sorted(got) == [1, 5, 10]
    for k in (1, 5, 10):
        want, nq_w = jval.recall_loop_closure(emb, poses, k)
        assert nq == nq_w and abs(got[k] - want) <= 1e-7
    assert got[1] < got[10]

def tied_recall_input(n=120, seed=9):
    """A two-lap loop whose embeddings take 3 values, so each query's
    k-th place is a tie among many candidates, near and far ones mixed:
    the lower index decides whether the query hits."""
    rng = np.random.default_rng(seed)
    poses = loop_trajectory(n, radius=40.0, loops=2.0)
    poses[:, :2, 3] += rng.normal(0, 0.5, (n, 2))
    table = rng.normal(size=(3, 8)).astype(np.float32)
    emb = table[rng.integers(0, 3, n)]
    return emb, poses


@pytest.mark.parametrize("k", [1, 5])
def test_recall_ties_go_to_the_lower_index(k):
    """On embeddings tied at the k-th place the port's Recall@k equals
    JAX's exactly (``lax.top_k`` takes the lower index first; the port
    ranks with ``smallest_k``), and equals the count a lower-index-first
    numpy ranking gives, which differs from the count of the
    higher-index-first one."""
    emb, poses = tied_recall_input()
    want, nq = jval.recall_loop_closure(emb, poses, k)
    got, nq_t = tval.recall_loop_closure(emb, poses, k, device="cpu")
    assert nq == nq_t > 10
    assert round(got * nq) == round(want * nq)      # JAX's mean is float32
    pos = poses[:, :3, 3].astype(np.float32)
    queries = jval.find_revisit_queries(pos, 5.0, 30)

    def hits(lower_first):
        total = 0
        for q, _ in queries:
            d = ((emb - emb[q]) ** 2).sum(1)
            d[max(0, q - 30):q + 31] = np.inf
            j = np.arange(len(d))
            order = np.lexsort((j if lower_first else -j, d))[:k]
            total += (np.linalg.norm(pos[order] - pos[q], axis=1)
                      < 5.0).any()
        return total
    assert hits(True) == round(want * nq)
    assert hits(False) != hits(True)


@pytest.mark.parametrize("entry", ["trainer", "revisit", "recall",
                                   "train_executable", "gather_bwd_cuda"])
def test_cuda_without_a_card_raises(entry):
    """Every new entry point asked for ``cuda`` without a card raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    emb, poses = tied_recall_input()
    net = SpectralGNN(16, 8, 16, n_layers=2)
    calls = {
        "trainer": lambda: GNNTrainer(model=net, device="cuda"),
        "revisit": lambda: tval.find_revisit_queries(
            poses[:, :3, 3], device="cuda"),
        "recall": lambda: tval.recall_loop_closure(emb, poses,
                                                   device="cuda"),
        "train_executable": lambda: TrainStepExecutable(
            net, make_optimizer(net), 8, 2, 2, 4, 0.1, 1.0, False, None,
            torch.device("cuda")),
        "gather_bwd_cuda": lambda: gk.gather_bwd_cuda(
            torch.zeros(3, 2), gk.make_plan(torch.zeros(3, dtype=torch.int64),
                                            2), 2),
    }
    with pytest.raises((RuntimeError, ValueError, AssertionError)):
        calls[entry]()


def test_train_releases_the_training_graphs(tmp_path):
    """``train`` ends by dropping the trainer's train step and embedding
    passes and the cached mining and validation executables, whose data
    would otherwise stay on the device."""
    desc, poses, graph = _toy()
    tr = _trainer(tmp_path, dropout=0.0)
    tr.train(graph, poses, desc, val_graph=graph, val_poses=poses,
             n_epochs=1, triplet_miner=tminer.TripletMiner(device="cpu"),
             save_best=False, save_last=False, save_every_epochs=0)
    assert tr.val_metrics and tr._train_exe is None and not tr._embed_exes
    assert not tminer.cached_executables()
    assert not tval.cached_executables()


def test_shared_pool_takes_a_new_pool_when_its_graphs_are_gone(
        monkeypatch):
    """A family's pool is handed out while a graph captured into it lives;
    once the last one is gone (the allocator would refuse another capture
    into it) the next capture gets a new pool, and a graph of the old pool
    dying later leaves the new one alone."""
    handles = iter([(0, 1), (0, 2), (0, 3)])
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: next(handles))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)

    class Graph:
        pass

    dev = torch.device("cuda", 0)
    pool = SharedPool()
    first = pool.handle(dev)
    a, b = Graph(), Graph()
    pool.track(dev, first, a)
    pool.track(dev, first, b)
    del a
    assert pool.handle(dev) == first
    del b
    second = pool.handle(dev)
    assert second != first
    c, late = Graph(), Graph()
    pool.track(dev, second, c)
    pool.track(dev, first, late)
    del late
    assert pool.handle(dev) == second

