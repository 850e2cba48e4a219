"""PyTorch port vs the JAX reference: bf16 mixed precision
(``training.mixed_precision``: ``SpectralGNN(compute_dtype=bfloat16)``).

The same ``init_gnn`` parameters (converted by ``from_flax``) drive the
JAX model with ``compute_dtype=jnp.bfloat16`` and the port's. Both round
to bf16 at the same points (each Dense and GAT product, the bias adds of
the Dense layers, the attention projections; float32 BatchNorm, softmax,
value sums and residuals), so the bars are well under bf16's own
resolution: forward outputs within 1e-2·max(|out|, 1) of JAX's. Gradients
are float32 and finite; against JAX's bf16 gradients within 5e-2 of each
tensor's largest entry, since the two frameworks' backward passes round
their products to bf16 at different points (the six gauge biases, whose
true gradient is 0, are noise on both sides and are left out)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neural_spectral_codec_tpu.data.synthetic import (  # noqa: E402
    loop_trajectory)
from neural_spectral_codec_tpu.keyframe.graph import (  # noqa: E402
    build_graph)
from neural_spectral_codec_tpu.models.gnn import (  # noqa: E402
    SpectralGNN as JaxGNN, gnn_forward as jax_forward, init_gnn)
from neural_spectral_codec_tpu.training import loss as jloss  # noqa: E402
from neural_spectral_codec_tpu.training import (  # noqa: E402
    trainer as jtrainer)
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: E402
    graph_to_tensors)
from neural_spectral_codec_torch.models import (  # noqa: E402
    SpectralGNN, from_flax)
from neural_spectral_codec_torch.models.gnn import (  # noqa: E402
    LocalUpdateGNN, gauge_parameters)
from neural_spectral_codec_torch.training import loss as tloss  # noqa: E402
from neural_spectral_codec_torch.training.trainer import (  # noqa: E402
    make_optimizer, train_step)

torch.set_num_threads(2)
BF16 = torch.bfloat16
# (input, hidden, output, nodes): test_gnn.py's mixed-precision shapes,
# and the full width on a small graph
SHAPES = [(64, 32, 64, 16), (32, 16, 32, 12), (800, 256, 800, 32)]


def _graph(n, d, seed=0):
    """test_gnn.py's ``_graph``."""
    rng = np.random.default_rng(seed)
    desc = rng.normal(size=(n, d)).astype(np.float32)
    return build_graph(desc, loop_trajectory(n), temporal_neighbors=5,
                       loop_closures=[(1, n - 2)])


def _pair(d_in, hidden, d_out, dropout=0.0):
    """JAX bf16 model and its params, port bf16 and float32 models with
    the same parameters."""
    kw = dict(input_dim=d_in, hidden_dim=hidden, output_dim=d_out)
    jm = JaxGNN(dropout=dropout, compute_dtype=jnp.bfloat16, **kw)
    params, bs = init_gnn(jm, jax.random.key(0))
    ports = []
    for dt in (BF16, None):
        m = SpectralGNN(dropout=dropout, compute_dtype=dt, **kw)
        m.load_state_dict(from_flax(params, bs))
        ports.append(m)
    return jm, params, bs, ports[0], ports[1]


def _run(model, graph):
    g = graph_to_tensors(graph, "cpu")
    return model(g.features, g.neighbors, g.mask, g.edge_feats)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}-{s[1]}")
def test_bf16_forward_matches_jax(shape):
    """Eval forward: float32 output within 1e-2·max(|out|, 1) of JAX's
    bf16 forward; parameters stay float32."""
    d_in, hidden, d_out, n = shape
    jm, params, bs, t16, _ = _pair(d_in, hidden, d_out)
    g = _graph(n, d_in)
    want = np.asarray(jax_forward(jm, params, bs, g))
    with torch.no_grad():
        got = _run(t16.eval(), g)
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in t16.parameters())
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got.numpy() - want).max() <= 1e-2 * scale


@pytest.mark.parametrize("shape", SHAPES[:1] + SHAPES[2:],
                         ids=lambda s: f"{s[0]}-{s[1]}")
def test_mixed_precision_forward_close_to_f32(shape):
    """test_gnn.py's bar against the port's float32 forward: within
    3e-2·max(|out32|, 1)."""
    d_in, hidden, d_out, n = shape
    _, _, _, t16, t32 = _pair(d_in, hidden, d_out)
    g = _graph(n, d_in)
    with torch.no_grad():
        out16, out32 = _run(t16.eval(), g), _run(t32.eval(), g)
    scale = max(float(out32.abs().max()), 1.0)
    assert float((out16 - out32).abs().max()) <= 3e-2 * scale


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: f"{s[0]}-{s[1]}")
def test_bf16_train_forward_and_grads_match_jax(shape):
    """Train mode, 64 triplets: embeddings within 1e-2·max(|emb|, 1) and
    the loss within 1e-2 relative of JAX's bf16 value_and_grad (run op by
    op, as test_gnn.py runs it: under jit XLA's fusions move bf16's
    rounding points in the backward pass, and the jitted gradients lie up
    to 9% in norm from the port's); the BatchNorm running statistics
    float32 and within 1e-3 of JAX's; gradients float32, finite and
    within 5e-2 of each tensor's largest JAX gradient (gauge biases left
    out)."""
    d_in, hidden, d_out, n = shape
    jm, params, bs, t16, _ = _pair(d_in, hidden, d_out)
    g = _graph(n, d_in)
    tri = np.random.default_rng(1).integers(0, n, (64, 3))

    def loss_fn(p):
        emb, upd = jm.apply({"params": p, "batch_stats": bs},
                            *[jnp.asarray(a) for a in g], train=True,
                            mutable=["batch_stats"])
        return jloss.triplet_loss(emb[tri[:, 0]], emb[tri[:, 1]],
                                  emb[tri[:, 2]], 0.1), (emb, upd)

    (jl, (jemb, upd)), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    t16.train()
    emb = _run(t16, g)
    t = torch.from_numpy(tri)
    loss = tloss.triplet_loss(emb[t[:, 0]], emb[t[:, 1]], emb[t[:, 2]], 0.1)
    loss.backward()
    assert emb.dtype == loss.dtype == torch.float32
    scale = max(float(np.abs(jemb).max()), 1.0)
    assert float((emb.detach() - torch.from_numpy(np.asarray(jemb)))
                 .abs().max()) <= 1e-2 * scale
    assert abs(float(loss) - float(jl)) <= 1e-2 * abs(float(jl))
    for i, bn in enumerate([t16.input_bn, *t16.gat_bns]):
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            buf = getattr(bn, ours)
            assert buf.dtype == torch.float32
            np.testing.assert_allclose(
                buf.numpy(), np.asarray(upd["batch_stats"][f"BatchNorm_{i}"]
                                        [theirs]), rtol=0, atol=1e-3)
    want = from_flax(jax.tree.map(np.asarray, jg))
    gauge = gauge_parameters(t16)
    for name, p in t16.named_parameters():
        assert p.grad.dtype == torch.float32
        assert bool(torch.isfinite(p.grad).all()), name
        if name not in gauge:
            w = want[name].numpy()
            assert np.abs(p.grad.numpy() - w).max() <= \
                5e-2 * np.abs(w).max(), name


def test_bf16_train_step_follows_jax():
    """Three full train steps (Adam, clip 1.0, lr 1e-4) of the bf16 model
    from the same parameters and triplets: each loss within 1e-2
    relative of JAX's bf16 ``train_step``; parameters float32."""
    d_in, hidden, d_out, n = SHAPES[0]
    jm, params, bs, t16, _ = _pair(d_in, hidden, d_out)
    g = _graph(n, d_in)
    tri = np.random.default_rng(2).integers(0, n, (64, 3))
    mask = np.ones(64, bool)
    jopt = jtrainer.make_optimizer(1e-4, 1e-5, 1.0)
    jstate = (params, bs, jopt.init(params))
    jg = [jnp.asarray(a) for a in g]
    opt = make_optimizer(t16, 1e-4, 1e-5)
    tg = graph_to_tensors(g, "cpu")
    t = torch.from_numpy(tri)
    for i in range(3):
        *jstate, jl = jtrainer.train_step(
            jm, jopt, *jstate, *jg, jnp.asarray(tri[:, 0]),
            jnp.asarray(tri[:, 1]), jnp.asarray(tri[:, 2]),
            jnp.asarray(mask), 0.1, jax.random.key(i))
        loss = train_step(t16, opt, tg, t[:, 0], t[:, 1], t[:, 2],
                          torch.from_numpy(mask), 0.1, grad_clip=1.0)
        assert abs(float(loss) - float(jl)) <= 1e-2 * abs(float(jl)), i
    assert all(p.dtype == torch.float32 for p in t16.parameters())


def test_bf16_serving_local_refresh():
    """The serving model computes in bf16 too (the JAX pipeline serves
    with the same model): ``LocalUpdateGNN`` on a bf16 model gives
    float32 embeddings equal to the bf16 full-graph forward's rows."""
    from neural_spectral_codec_torch.keyframe.graph import (
        TemporalGraphManager)
    from neural_spectral_codec_torch.keyframe.selector import Keyframe
    _, _, _, t16, _ = _pair(64, 32, 64)
    rng = np.random.default_rng(3)
    mgr = TemporalGraphManager(temporal_neighbors=2, max_active_nodes=64)
    for i in range(12):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 2.0 * i
        mgr.add_keyframe(Keyframe(
            keyframe_id=i, scan_id=i, points=None, pose=pose,
            timestamp=float(i),
            descriptor=rng.normal(size=64).astype(np.float32)))
    local = LocalUpdateGNN(t16.eval(), k_hops=5)
    full = local.forward_full(mgr.get_graph()).numpy()
    got = local.forward_local(mgr, 6).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[0], full[6], rtol=0, atol=1e-6)
