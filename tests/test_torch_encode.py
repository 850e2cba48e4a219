"""PyTorch port vs the JAX reference: general projection, interpolation
and the spectral encoder (plain versions of the CUDA kernels), plus the
kernel build and dispatch rules that hold without a GPU.

Tolerances. torch's and XLA's CPU ``atan2`` differ in the last ulp on a
few percent of points and XLA may fuse ``x*x + y*y``; a point near a bin
edge can then change bin. ``nudge_points`` moves every point at least
1e-3 of a bin width from any edge, and on such input images agree to
rtol 3e-7 (a 1-ulp range difference), atol 0, so empty pixels match
exactly. Descriptors: <= 1e-6 on nudged input, <= 1e-5 on raw scans.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import synthetic_scan  # noqa: E402
from neural_spectral_codec_tpu.ops import range_image as jri  # noqa: E402
from neural_spectral_codec_tpu.ops import spectral as jsp  # noqa: E402
from neural_spectral_codec_torch import _build  # noqa: E402
from neural_spectral_codec_torch.ops import range_image as tri  # noqa: E402
from neural_spectral_codec_torch.ops import spectral as tsp  # noqa: E402

torch.set_num_threads(2)


def nudge_points(pts: np.ndarray, config, margin: float = 1e-3) -> np.ndarray:
    """Move every finite point at least ``margin`` of a bin width away
    from each azimuth and elevation bin edge, keeping its range, so that
    a 1-ulp difference in atan2 cannot change its bin. Works in float64;
    the float32 rounding after it moves angles by ~1e-7 rad, far less
    than the margin."""
    p = np.asarray(pts, np.float64)
    fin = np.all(np.isfinite(p[..., :3]), axis=-1)
    x, y, z = (np.where(fin, p[..., i], 1.0) for i in range(3))
    r = np.sqrt(x * x + y * y + z * z)
    az = np.arctan2(y, x)
    el = np.arctan2(z, np.sqrt(x * x + y * y))
    u = (az + np.pi) / (2 * np.pi) * config.n_azimuth
    u = np.floor(u) + np.clip(u - np.floor(u), margin, 1 - margin)
    az = u / config.n_azimuth * 2 * np.pi - np.pi
    span = config.elevation_max - config.elevation_min
    v = (el - config.elevation_min) / span * config.n_elevation
    v = np.floor(v) + np.clip(v - np.floor(v), margin, 1 - margin)
    el = v / config.n_elevation * span + config.elevation_min
    new = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], axis=-1)
    out = np.array(pts, np.float32, copy=True)
    out[..., :3] = np.where(fin[..., None], new, out[..., :3])
    return out


def _test_images(rng, b=4):
    """Range images with sparse pixels, empty rows, a very sparse scan
    and an all-empty scan."""
    imgs = rng.uniform(0, 80, (b, 64, 360)).astype(np.float32)
    imgs[imgs < 15] = 0.0
    imgs[1, 10:14] = 0.0                   # empty rows, inside
    imgs[1, :3] = 0.0                      # leading empty rows
    imgs[2] *= rng.random((64, 360)) < 0.01   # one pixel in a hundred
    imgs[3] = 0.0                          # empty scan
    return imgs


@pytest.mark.parametrize("alpha", [0.5, 2.0, 3.0])
def test_bin_assignment_matches_jax(alpha):
    want = np.asarray(jsp.binning_matrix(jnp.float32(alpha), 50, 181))
    got = tsp.binning_matrix(alpha, 50, 181).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        tsp.compute_bin_edges(alpha, 50, 181).numpy(),
        np.asarray(jsp.compute_bin_edges(jnp.float32(alpha), 50, 181)),
        rtol=1e-6)


def test_numpy_helpers_are_copies():
    np.testing.assert_array_equal(tsp.pooling_matrix(64, 16),
                                  jsp.pooling_matrix(64, 16))
    for a, b in zip(tsp.dft_bases(360), jsp.dft_bases(360)):
        np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(tri.pad_points(pts, 64),
                                  jri.pad_points(pts, 64))


def test_interpolation_matches_jax():
    """Same blend, same row fill; XLA may contract the blend's products
    into an FMA, hence rtol 1e-6 instead of equality. Empty pixels and
    the all-empty scan must match exactly."""
    imgs = _test_images(np.random.default_rng(1))
    want = np.asarray(jax.vmap(jri.interpolate_range_image)(
        jnp.asarray(imgs)))
    got = tri.interpolate_range_image(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[3], 0.0)
    single = tri.interpolate_range_image(torch.from_numpy(imgs[1])).numpy()
    np.testing.assert_array_equal(single, got[1])


def test_fused_plain_matches_pallas_and_xla():
    """K1's plain version vs the Pallas kernel (interpret mode) and vs
    the XLA composition: <= 1e-6, with the uniform fallback."""
    from neural_spectral_codec_tpu.ops.pallas_spectral import (
        encode_range_image_batch_pallas)
    cfg = jsp.SpectralEncoderConfig()
    imgs = _test_images(np.random.default_rng(2))
    got = tsp.encode_images_plain(torch.from_numpy(imgs), 2.0,
                                  tsp.SpectralEncoderConfig()).numpy()
    pallas = np.asarray(encode_range_image_batch_pallas(
        jnp.asarray(imgs), jnp.float32(2.0), cfg, True))
    interp = jax.vmap(jri.interpolate_range_image)(jnp.asarray(imgs))
    xla = np.asarray(jsp.encode_range_image_batch(interp, jnp.float32(2.0),
                                                  cfg))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[3], 1.0 / 800, rtol=1e-7)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


def test_encode_without_interpolation_matches_jax():
    imgs = _test_images(np.random.default_rng(3))
    cfg = jsp.SpectralEncoderConfig(interpolate_empty=False)
    want = np.asarray(jsp.encode_range_image_batch(
        jnp.asarray(imgs), jnp.float32(1.5), cfg))
    got = tsp.encode_images(torch.from_numpy(imgs), 1.5,
                            tsp.SpectralEncoderConfig(
                                interpolate_empty=False)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["clip", "drop"])
def test_general_projection_matches_jax(mode):
    """K3+K4's plain version vs ``project_points_batch`` on nudged scans
    with NaN rows, below-gate ranges and (drop mode) out-of-band points."""
    rng = np.random.default_rng(4)
    cfg = jri.ProjectionConfig(elevation_mode=mode,
                               elevation_range_deg=(-20.0, 0.0))
    pts = np.stack([synthetic_scan(rng, 12000) for _ in range(2)])
    pts[1, 6000:] = np.nan
    pts = nudge_points(pts, cfg)
    want = np.asarray(jri.project_points_batch(jnp.asarray(pts), cfg))
    got = tri.project_points_batch(
        torch.from_numpy(pts), tri.ProjectionConfig(*cfg)).numpy()
    assert (want > 0).sum() > 5000
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)


def test_encode_points_batch_matches_jax():
    """<= 1e-6 on nudged scans; <= 1e-5 on raw scans. The raw seed is one
    where no point changes azimuth bin between the two CPU atan2s: such
    flips happen to about 7 points in a million, and one flip in a
    20,000-point scan moves its descriptor by up to ~6e-5 (seeds 5, 10)."""
    cfg = jsp.SpectralEncoderConfig(use_pallas=False)
    tcfg = tsp.SpectralEncoderConfig()
    rng = np.random.default_rng(5)
    nudged = nudge_points(np.stack([synthetic_scan(rng, 20000)
                                    for _ in range(2)]), cfg.projection)
    rng = np.random.default_rng(6)
    raw = np.stack([synthetic_scan(rng, 20000) for _ in range(2)])
    for pts, tol in ((nudged, 1e-6), (raw, 1e-5)):
        want = np.asarray(jsp.encode_points_batch(
            jnp.asarray(pts), jnp.float32(2.0), cfg))
        got = tsp.encode_points_batch(torch.from_numpy(pts), 2.0,
                                      tcfg).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_wrappers_route_by_device():
    """A CPU tensor takes the plain version and launches nothing; a
    tensor on any other device goes to the kernel binding, which refuses
    what is not CUDA (it never falls back to a plain version)."""
    from neural_spectral_codec_torch.ops import (
        projection_kernel, spectral_kernel)
    before = (projection_kernel.KERNEL.launches,
              spectral_kernel.KERNEL.launches)
    pts = torch.from_numpy(synthetic_scan(np.random.default_rng(6), 500))
    cfg = tsp.SpectralEncoderConfig()
    desc = tsp.encode_points_batch(pts[None], 2.0, cfg)
    assert desc.shape == (1, 800)
    assert before == (projection_kernel.KERNEL.launches,
                      spectral_kernel.KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tri.project_points_batch(pts[None].to("meta"), cfg.projection)
    with pytest.raises(ValueError, match="CUDA"):
        tsp.encode_images(torch.zeros((1, 64, 360), device="meta"), 2.0,
                          cfg)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A failing compiler raises with its output; nothing is returned and
    no library is left behind."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not list(tmp_path.glob("*.so"))


def test_launch_error_raises_and_is_not_counted(monkeypatch):
    kernel = _build.CudaKernel("nsc_test_symbol", [])
    kernel.__dict__["_fn"] = lambda *args: 2           # cudaErrorMemoryAllocation
    monkeypatch.setattr(_build, "error_string", lambda code: "out of memory")
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        kernel()
    assert kernel.launches == 0
    kernel.__dict__["_fn"] = lambda *args: 0
    kernel()
    assert kernel.launches == 1


def test_source_hash_follows_sources(tmp_path, monkeypatch):
    for src in _build.CSRC_DIR.glob("*.cu*"):
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    h0 = _build.source_hash()
    assert h0 == _build.source_hash()
    assert [s.name for s in _build.sources()] == [
        "gather_bwd.cu", "kabsch.cu", "knn.cu", "knn_pca.cu", "mine.cu",
        "nearest.cu", "project.cu", "query.cu", "ring_fold.cu",
        "ring_probe.cu", "roll_floor.cu", "select.cu", "spectral.cu"]
    (tmp_path / "common.cuh").write_text("// changed\n")
    h1 = _build.source_hash()
    assert h1 != h0
    (tmp_path / "sym3.cuh").write_text("// changed\n")
    assert _build.source_hash() != h1
