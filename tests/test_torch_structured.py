"""PyTorch port vs the JAX reference: the rest of the encode layer.

``encode_structured`` and its host helpers (ring ids from a sweep-order
or a firing-interleaved stream, bucketing into rings, rows of rings, the
contract check), nearest interpolation, the intensity projection,
unprojection, the image difference, ``RangeImageProjector`` and the 50-D
numpy encoder. Each takes the same numpy input as its JAX counterpart.

Tolerances. On nudged input (test_torch_encode.nudge_points) range
images are bit-equal and descriptors within 1e-6 (torch's and XLA's
float32 FFT and matmul sums differ in order). Host helpers and the
nearest fill copy values: equal. Unprojected points: atol 1e-4 m (XLA
and torch round the float32 grid angles and their sin/cos apart by an ulp
or two; an ulp of an azimuth near 2π is 4.8e-7 rad, 3.8e-5 m at the 80 m
range limit).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import synthetic_scan  # noqa: E402
from test_torch_encode import _test_images, nudge_points  # noqa: E402
from neural_spectral_codec_tpu.ops import range_image as jri  # noqa: E402
from neural_spectral_codec_tpu.ops import ring_path as jrp  # noqa: E402
from neural_spectral_codec_tpu.ops import spectral as jsp  # noqa: E402
from neural_spectral_codec_torch.ops import range_image as tri  # noqa: E402
from neural_spectral_codec_torch.ops import ring_path as trp  # noqa: E402
from neural_spectral_codec_torch.ops import spectral as tsp  # noqa: E402

torch.set_num_threads(2)

JCFG = jsp.SpectralEncoderConfig(use_pallas=False)
TCFG = tsp.SpectralEncoderConfig()
R, P = 16, 256


def _rings(seed, dropout=0.1):
    return nudge_points(jrp.make_structured_ring_scans(
        1, R, P, JCFG.projection, seed=seed, dropout=dropout)[0],
        JCFG.projection)                                  # (R, P, 4)


def _stream(name):
    """(flat (N, 4) cloud, per-point ring ids, ring path expected)."""
    if name == "sweep_order":          # KITTI .bin: ring-major, no ring field
        flat = _rings(20).reshape(-1, 4)
        return flat, trp.infer_ring_ids_from_sweep(flat), True
    if name == "interleaved":          # NCLT: firing order, no ring field
        flat = _rings(21).transpose(1, 0, 2).reshape(-1, 4)
        return flat, trp.infer_ring_ids_by_elevation(flat), True
    if name == "ring_field":           # HeLiPR: firing order + ring field
        flat = _rings(22, dropout=0.0).transpose(1, 0, 2).reshape(-1, 4)
        return flat, np.tile(np.arange(R), P), True
    if name == "unstructured":         # arbitrary order: general branch
        flat = _rings(23).reshape(-1, 4)
        flat = flat[np.random.default_rng(0).permutation(len(flat))]
        return flat, trp.infer_ring_ids_from_sweep(flat), False
    raise KeyError(name)


STREAMS = ["sweep_order", "interleaved", "ring_field", "unstructured"]


@pytest.mark.parametrize("name", STREAMS)
def test_ring_id_helpers_match_jax(name):
    flat, rid, _ = _stream(name)
    np.testing.assert_array_equal(trp.infer_ring_ids_from_sweep(flat),
                                  jrp.infer_ring_ids_from_sweep(flat))
    np.testing.assert_array_equal(trp.infer_ring_ids_by_elevation(flat),
                                  jrp.infer_ring_ids_by_elevation(flat))
    rings = trp.points_to_rings(flat, rid)
    np.testing.assert_array_equal(rings, jrp.points_to_rings(flat, rid))
    np.testing.assert_array_equal(
        trp.infer_row_of_ring(rings, TCFG.projection),
        jrp.infer_row_of_ring(rings, JCFG.projection))


@pytest.mark.parametrize("name", STREAMS)
def test_encode_structured_matches_jax(name):
    """Same branch as JAX (ring path or general path), the same prepared
    rings, the ring image bit-equal to the general image of the flat
    cloud, and descriptors <= 1e-6 from JAX's and from the port's own
    general path on the same cloud."""
    flat, rid, ring_path = _stream(name)
    prep = trp.prepare_structured(flat, rid, TCFG)
    jprep = jrp.prepare_structured(flat, rid, JCFG)
    assert (prep is not None) == ring_path == (jprep is not None)
    if ring_path:
        rings, rows = prep
        np.testing.assert_array_equal(rings, jprep[0])
        assert rows == jprep[1]
        img = trp.project_rings_batch(torch.from_numpy(rings[None]),
                                      TCFG.projection, rows).numpy()
        want = np.asarray(jri.project_points_batch(
            jnp.asarray(flat[None]), JCFG.projection))
        assert (want > 0).sum() > 2000
        np.testing.assert_array_equal(img, want)
    got = trp.encode_structured(flat, rid, 2.0, TCFG, device="cpu")
    assert got.shape == (800,) and got.device.type == "cpu"
    want = jrp.encode_structured(flat, rid, 2.0, JCFG)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    general = tsp.encode_points_batch(torch.from_numpy(flat[None]), 2.0,
                                      TCFG)[0]
    np.testing.assert_allclose(got.numpy(), general.numpy(), rtol=0,
                               atol=1e-6)


def test_prepare_structured_refuses_what_the_ring_path_would_lose():
    """A per_ring below a ring's point count, and rings that share a row,
    take the general branch on both sides."""
    flat, rid, _ = _stream("ring_field")
    assert trp.prepare_structured(flat, rid, TCFG, per_ring=P - 1) is None
    assert jrp.prepare_structured(flat, rid, JCFG, per_ring=P - 1) is None
    assert trp.prepare_structured(flat, rid % 8, TCFG) is None
    assert jrp.prepare_structured(flat, rid % 8, JCFG) is None


def test_nearest_interpolation_matches_jax():
    imgs = _test_images(np.random.default_rng(7))
    want = np.asarray(jax.vmap(lambda im: jri.interpolate_range_image(
        im, method="nearest"))(jnp.asarray(imgs)))
    got = tri.interpolate_range_image(torch.from_numpy(imgs),
                                      "nearest").numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown"):
        tri.interpolate_range_image(torch.from_numpy(imgs), "cubic")


def test_nearest_tie_takes_the_smaller_column():
    """Valid pixels at columns 1 (value 5) and 7 (value 9) of a 10-wide
    row: column 9 is 2 from both and takes column 1 across the wrap;
    column 4 is 3 from both and takes column 1 too."""
    img = np.zeros((2, 10), np.float32)
    img[:, 1], img[:, 7] = 5.0, 9.0
    got = tri.interpolate_range_image(torch.from_numpy(img),
                                      "nearest").numpy()
    want = np.asarray(jri.interpolate_range_image(jnp.asarray(img),
                                                  method="nearest"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [5, 5, 5, 5, 5, 9, 9, 9, 9, 5])


def test_intensity_projection_matches_jax():
    """Exact range ties (repeated points with other intensities), NaN and
    negative intensities, NaN points, below-gate ranges."""
    rng = np.random.default_rng(8)
    pts = synthetic_scan(rng, 6000)
    pts = np.concatenate([pts, pts[:800], pts[:400]])
    pts[6000:6800, 3] = rng.uniform(-1, 2, 800)
    pts[6800:, 3] = np.nan
    pts = nudge_points(pts, JCFG.projection)
    img, iimg = tri.project_points_with_intensity(torch.from_numpy(pts),
                                                  TCFG.projection)
    jimg, jiimg = jri.project_points_with_intensity(jnp.asarray(pts),
                                                    JCFG.projection)
    assert (np.asarray(jimg) > 0).sum() > 3000
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(iimg.numpy(), np.asarray(jiimg))
    assert (iimg.numpy() >= 0).all()
    np.testing.assert_array_equal(
        img.numpy(), tri.project_points_batch(torch.from_numpy(pts[None]),
                                              TCFG.projection)[0].numpy())


def test_unproject_and_difference_match_jax():
    imgs = _test_images(np.random.default_rng(9))
    for img in imgs[:3]:
        pts, mask = tri.unproject_range_image(torch.from_numpy(img),
                                              TCFG.projection)
        jpts, jmask = jri.unproject_range_image(jnp.asarray(img),
                                                JCFG.projection)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0,
                                   atol=1e-4)
    a, b = imgs[0], imgs[0] + np.where(imgs[0] > 40, 1.0, 0.0)
    for x, y in ((a, b), (a, imgs[2]), (a, np.zeros_like(a)), (a, a)):
        got = tri.range_image_difference(torch.from_numpy(x),
                                         torch.from_numpy(y), 0.5)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jri.range_image_difference(
                jnp.asarray(x), jnp.asarray(y), 0.5)))


def test_range_image_projector_matches_jax():
    pts = nudge_points(synthetic_scan(np.random.default_rng(10), 3000),
                       JCFG.projection)
    tproj = tri.RangeImageProjector(max_points=4096, device="cpu")
    jproj = jri.RangeImageProjector(max_points=4096)
    img, none = tproj.project(pts)
    jimg, _ = jproj.project(pts)
    assert none is None
    np.testing.assert_array_equal(img, jimg)
    img, iimg = tproj.project(pts, keep_intensity=True)
    jimg, jiimg = jproj.project(pts, keep_intensity=True)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(iimg, jiimg)
    back = tproj.unproject(img)
    assert back.shape == ((img > 0).sum(), 3)
    np.testing.assert_allclose(back, jproj.unproject(jimg), rtol=0,
                               atol=1e-4)


def test_numpy_50d_is_a_copy():
    imgs = _test_images(np.random.default_rng(11))
    for img in imgs:
        np.testing.assert_array_equal(
            tsp.encode_range_image_numpy_50d(img, alpha=1.5),
            jsp.encode_range_image_numpy_50d(img, alpha=1.5))
