"""The port's ``entry()`` against ``__graft_entry__.entry()`` (JAX): the
same example scans and graph from the same numpy draws, and the same
forward step on them with the JAX model's weights (``from_flax`` of its
``init_gnn`` parameters), on the CPU.

Tolerances: example inputs equal; descriptors <= 1e-6 on the example
scans passed through ``nudge_points`` (tests/test_torch_encode.py);
embeddings <= 1e-5, tests/test_torch_gnn.py's eval-forward bar.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from test_torch_encode import nudge_points  # noqa: E402
from neural_spectral_codec_torch.entry import entry  # noqa: E402
from neural_spectral_codec_torch.models.convert import from_flax  # noqa: E402
from neural_spectral_codec_torch.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig)

torch.set_num_threads(2)
DESC_TOL, EMB_TOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def both():
    return graft.entry(), entry(device="cpu")


def test_example_args_equal_jax(both):
    (_, jargs), (_, targs) = both
    points, alpha, model, neighbors, mask, edge_feats = targs
    assert points.shape == (8, 16384, 4) and points.device.type == "cpu"
    np.testing.assert_array_equal(points.numpy(), np.asarray(jargs[0]))
    assert float(alpha) == float(jargs[1]) == 2.0
    np.testing.assert_array_equal(neighbors.numpy(), np.asarray(jargs[4]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jargs[5]))
    np.testing.assert_array_equal(edge_feats.numpy(), np.asarray(jargs[6]))
    assert not model.training
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(p).size for p in jax.tree_util.tree_leaves(jargs[2]))


def test_forward_step_matches_jax(both):
    (jfn, jargs), (tfn, targs) = both
    params, stats = jargs[2], jargs[3]
    model = targs[2]
    model.load_state_dict(from_flax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, stats)))
    pts = nudge_points(np.asarray(jargs[0]),
                       SpectralEncoderConfig().projection)
    jd, je = jfn(jnp.asarray(pts), *jargs[1:])
    td, te = tfn(torch.from_numpy(pts), *targs[1:])
    assert td.shape == te.shape == (8, 800)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=DESC_TOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                               atol=EMB_TOL)
    np.testing.assert_allclose(td.sum(dim=1).numpy(), 1.0, atol=1e-4)
