"""The single-scan API of the port against the JAX package: the functional
``encode_points``, ``encode_range_image`` and ``project_points``, the
reference-facing ``SpectralEncoder`` (``encode_points``,
``encode_range_image``, ``forward``/``__call__``) and the 50-D
``SpectralEncoderNumpy``, on the CPU (the plain versions of the kernels).

Tolerances: descriptors <= 1e-6 and images bit-equal, on scans passed
through ``nudge_points`` (tests/test_torch_encode.py), which keeps every
point 1e-3 of a bin away from a bin edge, where XLA's and torch's float32
``atan2`` may disagree by an ulp.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402

from conftest import synthetic_scan  # noqa: E402
from test_torch_encode import _test_images, nudge_points  # noqa: E402
from neural_spectral_codec_tpu.ops import range_image as jri  # noqa: E402
from neural_spectral_codec_tpu.ops import spectral as jsp  # noqa: E402
from neural_spectral_codec_torch.ops import range_image as tri  # noqa: E402
from neural_spectral_codec_torch.ops import spectral as tsp  # noqa: E402
from neural_spectral_codec_torch.ops.ring_path import (  # noqa: E402
    make_structured_ring_scans)

torch.set_num_threads(2)
DESC_TOL = 1e-6
CFG = tsp.SpectralEncoderConfig()


def _scan(seed: int, n: int = 20000) -> np.ndarray:
    return nudge_points(synthetic_scan(np.random.default_rng(seed), n),
                        CFG.projection)


@pytest.mark.parametrize("mode", ["clip", "drop"])
def test_project_points_bit_equal(mode):
    """One padded scan → (64, 360), equal to JAX ``project_points`` bit
    for bit."""
    jcfg = jsp.SpectralEncoderConfig(elevation_mode=mode).projection
    tcfg = tsp.SpectralEncoderConfig(elevation_mode=mode).projection
    pts = tri.pad_points(_scan(1), 24576)
    want = np.asarray(jri.project_points(jnp.asarray(pts), jcfg))
    got = tri.project_points(torch.from_numpy(pts), tcfg)
    assert got.shape == (64, 360)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same as one row of the batch entry point
    assert torch.equal(got, tri.project_points_batch(
        torch.from_numpy(pts)[None], tcfg)[0])


def test_encode_points_matches_jax():
    pts = tri.pad_points(_scan(2), 24576)
    want = np.asarray(jsp.encode_points(jnp.asarray(pts), jnp.float32(2.0),
                                        jsp.SpectralEncoderConfig()))
    got = tsp.encode_points(torch.from_numpy(pts), 2.0, CFG)
    assert got.shape == (800,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DESC_TOL)


@pytest.mark.parametrize("alpha", [2.0, 1.3])
def test_encode_range_image_matches_jax(alpha):
    """The functional form encodes the image as it is (no interpolation),
    as JAX's does."""
    imgs = _test_images(np.random.default_rng(3))
    for img in imgs:
        want = np.asarray(jsp.encode_range_image(
            jnp.asarray(img), jnp.float32(alpha),
            jsp.SpectralEncoderConfig()))
        got = tsp.encode_range_image(torch.from_numpy(img), alpha, CFG)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DESC_TOL)


@pytest.fixture(scope="module")
def encoders():
    kw = dict(max_points=32768)
    return jsp.SpectralEncoder(**kw), tsp.SpectralEncoder(device="cpu", **kw)


def test_spectral_encoder_methods_match_jax(encoders):
    jenc, tenc = encoders
    assert tenc.output_dim == jenc.output_dim == 800
    assert tenc.config._asdict() == {k: v for k, v in
                                     jenc.config._asdict().items()
                                     if k != "use_pallas"}
    clouds = [_scan(10 + i, n) for i, n in enumerate((20000, 9000, 31000))]
    got = tenc.encode_points(clouds[0])
    np.testing.assert_allclose(got, jenc.encode_points(clouds[0]), rtol=0,
                               atol=DESC_TOL)
    batch = tenc.forward(clouds)
    assert batch.shape == (3, 800)
    np.testing.assert_allclose(batch, jenc.forward(clouds), rtol=0,
                               atol=DESC_TOL)
    np.testing.assert_array_equal(tenc(clouds), batch)
    np.testing.assert_array_equal(batch[0], got)
    for img in _test_images(np.random.default_rng(4)):
        np.testing.assert_allclose(tenc.encode_range_image(img),
                                   jenc.encode_range_image(img), rtol=0,
                                   atol=DESC_TOL)


def test_spectral_encoder_numpy_matches_jax():
    """The 50-D variant: range image from the projector, magnitudes of
    all rows in one histogram."""
    jenc = jsp.SpectralEncoderNumpy(max_points=32768)
    tenc = tsp.SpectralEncoderNumpy(max_points=32768, device="cpu")
    pts = _scan(5)
    got = tenc.encode_points(pts)
    assert got.shape == (50,)
    np.testing.assert_allclose(got, jenc.encode_points(pts), rtol=0,
                               atol=DESC_TOL)
    img = _test_images(np.random.default_rng(6))[0]
    np.testing.assert_allclose(tenc.encode_range_image(img),
                               jenc.encode_range_image(img), rtol=0,
                               atol=DESC_TOL)


def test_full_scan_is_cut_to_max_points():
    """A full HDL-64E scan (64 × 2088 = 133,632 points) through the
    default encoder loses its last 2,560 points, in the port as in JAX
    (``pad_points`` cuts at ``max_points`` = 131,072)."""
    full = make_structured_ring_scans(1, 64, 2088, CFG.projection,
                                      seed=7)[0].reshape(-1, 4)
    full = nudge_points(full, CFG.projection)
    tenc = tsp.SpectralEncoder(device="cpu")
    assert tenc.max_points == 131072 and len(full) == 133632
    got = tenc.encode_points(full)
    np.testing.assert_allclose(got, jsp.SpectralEncoder().encode_points(full),
                               rtol=0, atol=DESC_TOL)
    np.testing.assert_array_equal(got, tenc.encode_points(full[:131072]))
    uncut = tsp.encode_points(torch.from_numpy(full), 2.0, CFG).numpy()
    assert np.abs(got - uncut).max() > 1e-5
