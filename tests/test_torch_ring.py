"""PyTorch port vs the JAX reference: the ring-structured path (plain
version of the ring CUDA kernel) and its host-side numpy helpers.

Images are compared on nudged input (see test_torch_encode.nudge_points)
to rtol 3e-7, atol 0: empty pixels, kept points and dropped points must
match exactly, ranges to a 1-ulp sqrt difference between the two CPUs.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402

from test_torch_encode import nudge_points  # noqa: E402
from neural_spectral_codec_tpu.ops import ring_path as jrp  # noqa: E402
from neural_spectral_codec_tpu.ops.range_image import (  # noqa: E402
    ProjectionConfig)
from neural_spectral_codec_tpu.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig)
from neural_spectral_codec_torch.ops import range_image as tri  # noqa: E402
from neural_spectral_codec_torch.ops import ring_path as trp  # noqa: E402
from neural_spectral_codec_torch.ops import spectral as tsp  # noqa: E402

torch.set_num_threads(2)

CFG = ProjectionConfig()


def _sweep(n_turns, rows, per_ring, seed, config=CFG):
    """Rings at their rows' elevation centers sweeping ``n_turns`` turns
    of azimuth from random start angles: n_turns > 1 gives every ring
    extra wrap events."""
    rng = np.random.default_rng(seed)
    el = jrp.ring_elevation_centers(config, config.n_elevation)[list(rows)]
    r = len(rows)
    az = rng.uniform(0, 2 * np.pi, (1, r, 1)) \
        + np.linspace(0, n_turns * 2 * np.pi, per_ring)[None, None]
    rr = rng.uniform(2.0, 70.0, (1, r, per_ring))
    ce, se = np.cos(el)[None, :, None], np.sin(el)[None, :, None]
    return np.stack([rr * ce * np.cos(az), rr * ce * np.sin(az),
                     rr * se * np.ones_like(az), np.zeros_like(az)],
                    axis=-1).astype(np.float32)


def _case(name):
    if name == "structured":
        return jrp.make_structured_ring_scans(1, 64, 128, CFG, seed=1), \
            tuple(range(64)), 2, CFG
    if name == "extra_wrap_leading_holes_3_folds":
        rows = tuple(range(10, 18))
        pts = _sweep(2.5, rows, 300, seed=3)
        pts[0, 2, :40] = np.nan              # leading holes
        pts[0, 3, 100:130] = np.nan          # interior hole run
        pts[0, 4, ::3, :3] *= 0.01           # a third below min_range
        return pts, rows, 3, CFG
    if name == "extra_wrap_2_folds":
        rows = (5, 9, 40)
        return _sweep(1.7, rows, 250, seed=4), rows, 2, CFG
    if name == "drop_mode":
        cfg = CFG._replace(elevation_mode="drop",
                           elevation_range_deg=(-20.0, 0.0))
        pts = jrp.make_structured_ring_scans(1, 64, 128, CFG, seed=5)
        return pts, tuple(range(64)), 2, cfg
    raise KeyError(name)


@pytest.mark.parametrize("name", ["structured",
                                  "extra_wrap_leading_holes_3_folds",
                                  "extra_wrap_2_folds", "drop_mode"])
def test_ring_projection_matches_jax(name):
    pts, rows, n_folds, cfg = _case(name)
    pts = nudge_points(pts, cfg)
    want = np.asarray(jrp.project_rings_batch(jnp.asarray(pts), cfg, rows,
                                              n_folds))
    got = trp.project_rings_batch(torch.from_numpy(pts),
                                  tri.ProjectionConfig(*cfg), rows,
                                  n_folds).numpy()
    assert (want > 0).sum() > 100
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)


def test_fold_rule_drops_from_the_n_folds_th_wrap():
    """The fold rule on a hand-made ring: bins 5, 6, 2 (event 1), 3,
    1 (event 2), 4. With n_folds=2 the last two points are dropped; with
    n_folds=3 all are kept."""
    bins = np.array([5, 6, 2, 3, 1, 4])
    rng_m = np.array([10.0, 11.0, 12.0, 13.0, 14.0, 15.0])
    el = jrp.ring_elevation_centers(CFG, 64)[7]
    az = (bins + 0.5) / 360 * 2 * np.pi - np.pi
    ring = np.stack([rng_m * np.cos(el) * np.cos(az),
                     rng_m * np.cos(el) * np.sin(az),
                     rng_m * np.sin(el), np.zeros(6)], -1)
    pts = torch.from_numpy(ring[None, None].astype(np.float32))
    cfg = tri.ProjectionConfig()
    row2 = trp.ring_rows_plain(pts, cfg, 2)[0, 0].numpy()
    row3 = trp.ring_rows_plain(pts, cfg, 3)[0, 0].numpy()
    assert set(np.flatnonzero(row2)) == {2, 3, 5, 6}
    assert set(np.flatnonzero(row3)) == {1, 2, 3, 4, 5, 6}
    np.testing.assert_allclose(row3[[1, 4]], [14.0, 15.0], rtol=1e-6)


@pytest.mark.parametrize("n_folds", [2, 3])
def test_ring_rows_plain_matches_pallas_interpret(n_folds):
    """K2's plain version vs ``ring_fold_pallas`` (interpret mode) +
    ``_fold_min``, per ring."""
    from neural_spectral_codec_tpu.ops.pallas_ring import ring_fold_pallas
    rows = tuple(range(20, 24))
    pts = _sweep(1.3 if n_folds == 3 else 1.0, rows, 200, seed=11)
    pts[0, :, ::7] = np.nan
    pts[0, 1, :25] = np.nan
    pts = nudge_points(pts, CFG)
    vals, key = jrp._ring_keys(jnp.asarray(pts), CFG)
    key = jnp.pad(key, ((0, 0), (0, 0), (0, 56)), constant_values=-1.0)
    vals = jnp.pad(vals, ((0, 0), (0, 0), (0, 56)), constant_values=jnp.inf)
    folded = ring_fold_pallas(key.reshape(4, 256), vals.reshape(4, 256),
                              CFG.n_azimuth, n_folds, interpret=True)
    width = n_folds * CFG.n_azimuth
    want = np.asarray(jrp._fold_min(folded[:, :width].reshape(1, 4, width),
                                    n_folds, CFG.n_azimuth))
    got = trp.ring_rows_plain(torch.from_numpy(pts), tri.ProjectionConfig(),
                              n_folds).numpy()
    assert (want > 0).sum() > 100
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)


def test_encode_points_ring_batch_matches_jax_and_general_path():
    enc = SpectralEncoderConfig(use_pallas=False)
    pts = nudge_points(jrp.make_structured_ring_scans(1, 64, 128,
                                                      enc.projection,
                                                      seed=6),
                       enc.projection)
    rows = tuple(range(64))
    want = np.asarray(jrp.encode_points_ring_batch(
        jnp.asarray(pts), jnp.float32(2.0), enc, rows))
    tcfg = tsp.SpectralEncoderConfig()
    t = torch.from_numpy(pts)
    got = trp.encode_points_ring_batch(t, 2.0, tcfg, rows).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # on contract-satisfying input the port's two paths agree exactly
    general = tsp.encode_points_batch(t.reshape(1, -1, 4), 2.0, tcfg).numpy()
    np.testing.assert_array_equal(got, general)


def test_host_helpers_are_copies():
    np.testing.assert_array_equal(
        trp.make_structured_ring_scans(2, 8, 50, CFG, seed=3),
        jrp.make_structured_ring_scans(2, 8, 50, CFG, seed=3))
    np.testing.assert_array_equal(trp.ring_elevation_centers(CFG, 64),
                                  jrp.ring_elevation_centers(CFG, 64))
    pts = jrp.make_structured_ring_scans(1, 8, 64, CFG, seed=4)
    pts[0, 2] = _sweep(2.2, (2,), 64, seed=5)[0, 0]
    rows = list(range(8))
    assert trp.ring_structure_report(pts, CFG, rows) == \
        jrp.ring_structure_report(pts, CFG, rows)


def test_row_of_ring_is_checked():
    pts = torch.zeros((1, 3, 8, 4))
    cfg = tri.ProjectionConfig()
    for rows in ((0, 2, 1), (0, 1, 1), (0, 1, 64), (0, 1)):
        with pytest.raises(ValueError):
            trp.project_rings_batch(pts, cfg, rows)
    with pytest.raises(ValueError, match="CUDA"):
        trp.project_rings_batch(pts.to("meta"), cfg, (0, 1, 2))
