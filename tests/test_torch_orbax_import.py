"""The Orbax → PyTorch checkpoint import (``convert_orbax_checkpoint.py``).

The JAX package's ``GNNTrainer`` trains one epoch on the CPU and saves an
Orbax checkpoint; the converter turns it into the port trainer's ``.pt``.
The port's pipeline then serves the JAX weights (embeddings within the
``from_flax`` bar of JAX's ``gnn_forward`` on the restored parameters,
1e-5), and a port trainer resumed from it starts at the JAX trainer's
epoch, step, Adam moments and learning rate, and its next epoch's loss
follows JAX's (rtol 1e-4)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402

import convert_orbax_checkpoint as conv  # noqa: E402
from neural_spectral_codec_tpu.data.synthetic import (  # noqa: E402
    loop_trajectory)
from neural_spectral_codec_tpu.keyframe.graph import (  # noqa: E402
    build_graph)
from neural_spectral_codec_tpu.models.gnn import (  # noqa: E402
    SpectralGNN as JaxGNN, gnn_forward as jax_forward, init_gnn)
from neural_spectral_codec_tpu.training import (  # noqa: E402
    trainer as jtrainer)
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: E402
    graph_to_tensors)
from neural_spectral_codec_torch.models import (  # noqa: E402
    SpectralGNN, from_flax)
from neural_spectral_codec_torch.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline)
from neural_spectral_codec_torch.training.trainer import (  # noqa: E402
    GNNTrainer)
from test_pipeline import small_config  # noqa: E402

torch.set_num_threads(2)
WIDTHS = dict(input_dim=160, hidden_dim=32, output_dim=160)   # small_config


class _Fixed:
    def __init__(self, triplets):
        self.triplets = triplets

    def mine_triplets(self, **kw):
        return self.triplets


def _data(n=48, seed=0):
    rng = np.random.default_rng(seed)
    desc = rng.random((n, 160)).astype(np.float32)
    desc /= desc.sum(axis=1, keepdims=True)
    poses = loop_trajectory(n)
    tri = np.stack([rng.integers(0, n, 300) for _ in range(3)], 1)
    return build_graph(desc, poses), poses, desc, tri


@pytest.fixture(scope="module", params=["constant-lr", "decayed-lr"])
def jax_checkpoint(request, tmp_path_factory):
    """A JAX trainer after one epoch (3 steps of 128 triplets; with the
    step schedule, its lr decayed to 5e-5 in the optimizer state), saved
    with Orbax and converted by the script's CLI."""
    tmp = tmp_path_factory.mktemp(request.param)
    graph, poses, desc, tri = _data()
    decay = request.param == "decayed-lr"
    jt = jtrainer.GNNTrainer(model=JaxGNN(dropout=0.0, **WIDTHS),
                             checkpoint_dir=str(tmp / "orbax"),
                             triplets_per_step=128, seed=3,
                             lr_decay_epochs=[1] if decay else None)
    jt.train_epoch(graph, _Fixed(tri), poses, desc)
    if decay:
        jt.current_lr = 5e-5
        jt.opt_state.hyperparams["learning_rate"] = np.float32(5e-5)
    jt.epoch, jt.best_val_metric = 1, 0.25
    jt.save_checkpoint("ck")
    out = tmp / "port" / "ck.pt"
    conv.main([str(tmp / "orbax" / "ck"), str(out)])
    return jt, out, (graph, poses, desc, tri)


def test_converted_weights_serve_like_jax(jax_checkpoint, tmp_path):
    """The pipeline loads the converted .pt; its eval embeddings equal
    JAX's gnn_forward on the restored Orbax parameters within 1e-5."""
    jt, out, (graph, *_rest) = jax_checkpoint
    restored = ocp.PyTreeCheckpointer().restore(
        str((jt.checkpoint_dir / "ck").absolute()))
    want = np.asarray(jax_forward(JaxGNN(dropout=0.0, **WIDTHS),
                                  restored["params"],
                                  restored["batch_stats"], graph))
    pipe = NeuralSpectralCodecPipeline(small_config(tmp_path), device="cpu")
    assert not pipe.weights_loaded
    pipe.load_checkpoint(str(out))
    assert pipe.weights_loaded
    model = pipe.model.eval()
    g = graph_to_tensors(graph, "cpu")
    with torch.no_grad():
        got = model(g.features, g.neighbors, g.mask, g.edge_feats).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resumed_trainer_continues_jax_training(jax_checkpoint, tmp_path):
    """GNNTrainer.load_checkpoint on the converted .pt: the JAX trainer's
    epoch, step, best metric and losses; Adam's step count and moments
    equal to optax's (exactly, mapped by from_flax); the learning rate
    the checkpoint holds. One more epoch of the same triplets then gives
    JAX's epoch loss within rtol 1e-4."""
    jt, out, (graph, poses, desc, tri) = jax_checkpoint
    pt = GNNTrainer(model=SpectralGNN(dropout=0.0, **WIDTHS),
                    checkpoint_dir=str(out.parent), triplets_per_step=128,
                    seed=0, device="cpu")
    pt.load_checkpoint("ck")
    assert (pt.epoch, pt.global_step) == (jt.epoch, jt.global_step) == (1, 3)
    assert pt.best_val_metric == 0.25
    np.testing.assert_allclose(pt.train_losses, jt.train_losses, rtol=1e-7)
    np.testing.assert_allclose(pt.current_lr, jt.current_lr, rtol=1e-6)
    # make_optimizer's chain: clip, decayed weights, adam (itself
    # scale_by_adam, then the learning rate), inside inject_hyperparams
    # with the step schedule
    adam = getattr(jt.opt_state, "inner_state", jt.opt_state)[2][0]
    mu, nu = (from_flax(jax.tree.map(np.asarray, m))
              for m in (adam.mu, adam.nu))
    for name, p in pt.model.named_parameters():
        st = pt.optimizer.state[p]
        assert float(st["step"]) == float(adam.count) == 3
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
    jt.epoch = pt.epoch = 1
    lj = jt.train_epoch(graph, _Fixed(tri), poses, desc)
    lp = pt.train_epoch(graph, _Fixed(tri), poses, desc)
    np.testing.assert_allclose(lp, lj, rtol=1e-4)


def test_converter_refuses_a_tree_without_adam(tmp_path):
    """A checkpoint whose optimizer state holds no Adam moments is
    refused; the widths of a restored tree give the port's model."""
    params, stats = init_gnn(JaxGNN(**WIDTHS), jax.random.key(0))
    assert conv.model_widths(jax.tree.map(np.asarray, params)) == dict(
        n_layers=3, edge_dim=2, residual=True, **WIDTHS)
    ocp.PyTreeCheckpointer().save(
        str(tmp_path / "bad"), {"params": params, "batch_stats": stats,
                                "opt_state": [np.zeros(2, np.float32)],
                                "meta": {"epoch": 0}})
    with pytest.raises(ValueError, match="no Adam state"):
        conv.convert(str(tmp_path / "bad"), str(tmp_path / "bad.pt"))
