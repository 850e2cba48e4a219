"""PyTorch port vs the JAX reference: the SpectralGNN eval forward with
Flax parameters converted by ``from_flax``, the GAT layer, and the
keyframe graph builder. Tolerance: 1e-5 (float32 matmuls summed in
different orders)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neural_spectral_codec_tpu.keyframe.graph import (  # noqa: E402
    build_graph as jax_build_graph)
from neural_spectral_codec_tpu.models.gnn import (  # noqa: E402
    EdgeGATLayer as JaxGAT, SpectralGNN as JaxGNN, gnn_forward, init_gnn)
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: E402
    build_graph, graph_to_tensors)
from neural_spectral_codec_torch.models import (  # noqa: E402
    EdgeGATLayer, SpectralGNN, from_flax)
from neural_spectral_codec_torch.models.gnn import (  # noqa: E402
    gnn_forward as torch_gnn_forward)

torch.set_num_threads(2)


def _poses(n, rng):
    """Straight-line trajectory with yaw noise."""
    poses = np.tile(np.eye(4), (n, 1, 1))
    yaw = rng.uniform(-0.3, 0.3, n)
    poses[:, 0, 0], poses[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    poses[:, 1, 0], poses[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    poses[:, 0, 3] = np.arange(n) * 2.0
    return poses


def _graph(n=12, seed=0, width=800):
    rng = np.random.default_rng(seed)
    desc = rng.random((n, width)).astype(np.float32)
    desc /= desc.sum(axis=1, keepdims=True)
    return build_graph(desc, _poses(n, rng),
                       loop_closures=[(0, 9), (2, 11), (3, 10), (0, 11)])


def _perturbed_flax(model, seed):
    """init_gnn parameters with non-trivial BatchNorm statistics and
    biases, so that every converted field matters."""
    params, stats = init_gnn(model, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), params)
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a), stats)
    for bn in stats.values():
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return params, stats


def test_build_graph_is_a_copy():
    rng = np.random.default_rng(1)
    desc = rng.random((15, 8)).astype(np.float32)
    poses = _poses(15, rng)
    loops = [(0, 9), (2, 11), (3, 10), (0, 11), (0, 12), (0, 13), (0, 14)]
    got, want = build_graph(desc, poses, 5, loops), \
        jax_build_graph(desc, poses, 5, loops)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_from_flax_full_width_matches_jax():
    """Full-width SpectralGNN (800 → 256 → 800, 3 GAT layers, edge_dim 2)
    on a 12-node graph with loop edges: eval embeddings and attention
    <= 1e-5."""
    model = JaxGNN()
    params, stats = _perturbed_flax(model, 0)
    g = _graph()
    want, want_att = model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(g.features),
        jnp.asarray(g.neighbors), jnp.asarray(g.mask),
        jnp.asarray(g.edge_feats), train=False, return_attention=True)
    want_fwd = np.asarray(gnn_forward(model, params, stats, g))
    net = SpectralGNN()
    net.load_state_dict(from_flax(params, stats))
    net.eval()
    t = graph_to_tensors(g, "cpu")
    got = torch_gnn_forward(net, t).numpy()
    with torch.no_grad():
        _, got_att = net(t.features, t.neighbors, t.mask, t.edge_feats,
                         return_attention=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_fwd, rtol=0, atol=1e-5)
    for a, b in zip(got_att, want_att):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_from_flax_conventions():
    """Dense kernels are transposed, BatchNorm fields renamed, GAT vectors
    flattened; BatchNorm momentum is PyTorch's 0.1 for Flax's 0.9."""
    model = JaxGNN(input_dim=16, hidden_dim=8, output_dim=12, n_layers=2)
    params, stats = _perturbed_flax(model, 1)
    sd = from_flax(params, stats)
    np.testing.assert_array_equal(sd["input_proj.weight"].numpy(),
                                  params["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(sd["output_proj.weight"].numpy(),
                                  params["Dense_1"]["kernel"].T)
    np.testing.assert_array_equal(sd["residual_proj.weight"].numpy(),
                                  params["residual_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["gat_layers.1.lin.weight"].numpy(),
                                  params["EdgeGATLayer_1"]["lin"].T)
    np.testing.assert_array_equal(sd["gat_layers.0.att_src"].numpy(),
                                  params["EdgeGATLayer_0"]["att_src"][0])
    np.testing.assert_array_equal(sd["gat_bns.1.running_var"].numpy(),
                                  stats["BatchNorm_2"]["var"])
    np.testing.assert_array_equal(sd["input_bn.weight"].numpy(),
                                  params["BatchNorm_0"]["scale"])
    net = SpectralGNN(input_dim=16, hidden_dim=8, output_dim=12, n_layers=2)
    net.load_state_dict(from_flax(params, stats))     # strict: all fields
    assert all(bn.momentum == pytest.approx(1 - 0.9)
               for bn in [net.input_bn, *net.gat_bns])
    # the residual projection path (input_dim != output_dim) agrees too
    g = _graph(n=9, seed=2, width=16)
    want = np.asarray(gnn_forward(model, params, stats, g))
    got = torch_gnn_forward(net.eval(), graph_to_tensors(g, "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_gat_layer_matches_jax_with_isolated_node():
    rng = np.random.default_rng(3)
    n, d, c = 6, 10, 7
    x = rng.normal(size=(n, d)).astype(np.float32)
    nbr = rng.integers(0, n, (n, 4)).astype(np.int32)
    mask = rng.random((n, 4)) < 0.6
    mask[2] = False                                   # isolated node
    ef = rng.random((n, 4, 2)).astype(np.float32)
    layer = JaxGAT(features=c, edge_dim=2)
    p = layer.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(nbr),
                   jnp.asarray(mask), jnp.asarray(ef))["params"]
    want, want_a = layer.apply({"params": p}, jnp.asarray(x),
                               jnp.asarray(nbr), jnp.asarray(mask),
                               jnp.asarray(ef))
    t = EdgeGATLayer(d, c, edge_dim=2)
    with torch.no_grad():
        t.lin.weight.copy_(torch.tensor(np.asarray(p["lin"]).T))
        t.lin_edge.weight.copy_(torch.tensor(np.asarray(p["lin_edge"]).T))
        for name in ("att_src", "att_dst", "att_edge"):
            getattr(t, name).copy_(torch.tensor(np.asarray(p[name])[0]))
        out, a = t(torch.from_numpy(x), torch.from_numpy(nbr).long(),
                   torch.from_numpy(mask), torch.from_numpy(ef))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(a[2].numpy(), [0, 0, 0, 0, 1], atol=0)


def test_bn_train_step_matches_flax_running_stats():
    """One train-mode forward on 16 nodes (full width, dropout 0): every
    BatchNorm's new running mean and variance are within 1e-6 of Flax's
    new ``batch_stats``, the embeddings within 5e-5 (train-mode BatchNorm
    on 16 nodes is ill-conditioned in float32: on this input the port is
    1.39e-5 and Flax 1.15e-5 from a float64 forward, and 1.38e-5 from each
    other). Flax normalises with, and averages in, the biased batch
    variance; ``nn.BatchNorm1d`` averages in the unbiased one, 16/15 of it
    here (6.7% too large, the fault this test pins). The parameters are
    ``init_gnn``'s (zero biases: a perturbed Dense bias puts the first
    BatchNorm's input mean ~300x above its spread, where the variance
    cancels and both frameworks are good to 1e-4 only); the statistics
    going in are perturbed."""
    model = JaxGNN(dropout=0.0)
    params, _ = init_gnn(model, jax.random.key(4))
    _, stats = _perturbed_flax(model, 4)
    g = _graph(n=16, seed=4)
    want, upd = model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(g.features),
        jnp.asarray(g.neighbors), jnp.asarray(g.mask),
        jnp.asarray(g.edge_feats), train=True, mutable=["batch_stats"])
    net = SpectralGNN(dropout=0.0)
    net.load_state_dict(from_flax(params, stats))
    net.train()
    t = graph_to_tensors(g, "cpu")
    with torch.no_grad():
        got = net(t.features, t.neighbors, t.mask, t.edge_feats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-5)
    new = upd["batch_stats"]
    for i, bn in enumerate([net.input_bn, *net.gat_bns]):
        w = new[f"BatchNorm_{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(w["mean"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(w["var"]), rtol=0, atol=1e-6)


def test_gat_attention_returned_after_dropout():
    """In train mode the layer returns the attention it applied, after
    dropout (as Flax's ``EdgeGATLayer`` does): out = α·[h_nbr; h] + bias
    with the returned α, whose kept entries are softmax / (1 − p) and
    whose dropped entries are 0."""
    rng = np.random.default_rng(5)
    n, d, c, p = 40, 10, 7, 0.5
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    nbr = torch.from_numpy(rng.integers(0, n, (n, 4))).long()
    mask = torch.from_numpy(rng.random((n, 4)) < 0.8)
    ef = torch.from_numpy(rng.random((n, 4, 2)).astype(np.float32))
    layer = EdgeGATLayer(d, c, edge_dim=2, attn_dropout=p)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.eval()
        _, soft = layer(x, nbr, mask, ef)
        layer.train()
        torch.manual_seed(0)
        out, alpha = layer(x, nbr, mask, ef)
        h = layer.lin(x)
        vals = torch.cat([h[nbr], h[:, None, :]], dim=1)
        applied = torch.einsum("nd,ndc->nc", alpha, vals) + layer.bias
    np.testing.assert_allclose(out.numpy(), applied.numpy(), rtol=0,
                               atol=1e-6)
    kept = alpha != 0
    assert bool((~kept & (soft > 0)).any()), "no attention entry dropped"
    np.testing.assert_allclose(alpha[kept].numpy(),
                               (soft[kept] / (1 - p)).numpy(), rtol=1e-6)


def test_gnn_forward_train_mode_matches_jax():
    """``gnn_forward(train=True)`` against JAX's on 32 nodes (full width,
    dropout 0, ``init_gnn`` parameters, perturbed statistics): embeddings
    within 5e-5 (see the test above), the BatchNorm buffers updated in
    place to within 1e-6 of JAX's new ``batch_stats``, the autograd graph
    kept; a model in the other mode raises. ``create_spectral_gnn`` builds
    the same network, and with ``mixed_precision`` the same parameters
    with a bf16 compute dtype (its numbers: test_torch_mixed_precision)."""
    model = JaxGNN(dropout=0.0)
    params, _ = init_gnn(model, jax.random.key(6))
    _, stats = _perturbed_flax(model, 6)
    g = _graph(n=32, seed=6)
    want, new = gnn_forward(model, params, stats, g, train=True)
    from neural_spectral_codec_torch.models.gnn import create_spectral_gnn
    net = create_spectral_gnn(dropout=0.0)
    net.load_state_dict(from_flax(params, stats))
    t = graph_to_tensors(g, "cpu")
    with pytest.raises(ValueError, match="train"):
        torch_gnn_forward(net.eval(), t, train=True)
    got = torch_gnn_forward(net.train(), t, train=True)
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=5e-5)
    for i, bn in enumerate([net.input_bn, *net.gat_bns]):
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, ours).numpy(),
                np.asarray(new[f"BatchNorm_{i}"][theirs]), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="eval"):
        torch_gnn_forward(net, t)
    bf16 = create_spectral_gnn(dropout=0.0, mixed_precision=True)
    assert net.compute_dtype is None
    assert bf16.compute_dtype is torch.bfloat16
    assert all(g.compute_dtype is torch.bfloat16 for g in bf16.gat_layers)
    assert bf16.state_dict().keys() == net.state_dict().keys()


def test_seeded_init_is_reproducible():
    a = SpectralGNN(generator=torch.Generator().manual_seed(7))
    b = SpectralGNN(generator=torch.Generator().manual_seed(7))
    c = SpectralGNN(generator=torch.Generator().manual_seed(8))
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.input_proj.weight, c.input_proj.weight)
    lim = np.sqrt(6.0 / 512)              # Glorot bound of a 256x256 GAT
    assert a.gat_layers[0].lin.weight.abs().max() <= lim
