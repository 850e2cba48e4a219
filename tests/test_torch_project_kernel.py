"""The host side of the general-projection kernel (``csrc/project.cu``) on
the CPU, where the kernel itself cannot run.

``kernel_model`` repeats the kernel in numpy, step by step: the points cut
into chunks of a scan and taken by CTAs in turn, the float32 angle guesses,
the walk against the edge tables with the double-word side test (float32
arithmetic, the FMA split done exactly in float64), the points it defers
to the float64 path, the scatter-min into the scratch images, and the
decode of 16-byte words in grid-stride order, which leaves the scratch at
+inf. Its images must equal the plain version bit for bit, and JAX's
``project_points_batch`` on points nudged off the bin edges (rtol 3e-7,
atol 0, as in ``test_torch_encode``: XLA may fuse x*x + y*y).
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from neural_spectral_codec_tpu.ops import range_image as jri  # noqa: E402
from neural_spectral_codec_torch import _build  # noqa: E402
from neural_spectral_codec_torch.ops import projection_kernel as pk  # noqa: E402
from neural_spectral_codec_torch.ops import range_image as tri  # noqa: E402
from neural_spectral_codec_torch.ops.ring_path import (  # noqa: E402
    make_structured_ring_scans)
from test_torch_encode import nudge_points  # noqa: E402

torch.set_num_threads(2)

F32 = np.float32
CLIP = tri.ProjectionConfig()
DROP = tri.ProjectionConfig(elevation_mode="drop",
                            elevation_range_deg=(-20.0, 0.0))
# the polynomial of atan2_guess, as the kernel's float literals
POLY = [F32(c) for c in (0.99997726, -0.33262347, 0.19354346, -0.11643287,
                         0.05265332, -0.01172120)]


def atan2_guess(y, x):
    ax, ay = np.abs(x), np.abs(y)
    with np.errstate(all="ignore"):
        t = (np.minimum(ax, ay) / np.maximum(ax, ay)).astype(F32)
    t2 = (t * t).astype(F32)
    p = POLY[5]
    for c in POLY[4::-1]:
        p = (p * t2 + c).astype(F32)
    r = (p * t).astype(F32)
    r = np.where(ay > ax, (F32(1.57079637) - r).astype(F32), r)
    r = np.where(x < 0, (F32(3.14159274) - r).astype(F32), r)
    return np.where(np.signbit(y), -r, r).astype(F32)


def edge_side(u, v, c):
    """The kernel's edge_side: u cos m - v sin m with c = (cos hi, lo, sin
    hi, lo), float32, products split exactly."""
    ch, cl, sh, sl = (c[..., j] for j in range(4))
    p1, p2 = (u * ch).astype(F32), (v * sh).astype(F32)
    e1 = (u.astype(np.float64) * ch - p1).astype(F32)   # fma(u, ch, -p1)
    e2 = (v.astype(np.float64) * sh - p2).astype(F32)
    small = ((e1 - e2).astype(F32)
             + ((u * cl).astype(F32) - (v * sl).astype(F32)).astype(F32))
    return ((p1 - p2).astype(F32) + small.astype(F32)).astype(F32)


def edge_walk(u, v, level, k, table, margin):
    """The kernel's edge_walk over arrays: the level, or -1."""
    out = np.full(u.shape, -1)
    level = level.copy()
    alive = np.ones(u.shape, bool)
    for _ in range(2):
        lo = np.where(level > 0, edge_side(
            u, v, table[np.clip(level - 1, 0, k - 1)]), np.inf)
        hi = np.where(level < k, edge_side(
            u, v, table[np.clip(level, 0, k - 1)]), -np.inf)
        done = alive & (lo > margin) & (hi < -margin)
        out[done] = level[done]
        alive &= ~done
        down = alive & (lo < -margin) & (level > 0)
        up = alive & ~down & (hi > margin) & (level < k)
        alive &= down | up
        level = np.where(down, level - 1, np.where(up, level + 1, level))
    return out


def point_pixels(pts, cfg):
    """The kernel's per-point result: (pixel or -1, range, deferred)."""
    x, y, z = (np.ascontiguousarray(pts[:, i], F32) for i in range(3))
    t = torch.from_numpy(pts[None, :, :3].copy())
    rng, azimuth, elevation, finite = tri._spherical(t)
    valid = tri._valid_mask(rng, elevation, finite, cfg)[0].numpy()
    exact = (tri.elevation_bins(elevation, cfg) * cfg.n_azimuth
             + tri.azimuth_bins(azimuth, cfg.n_azimuth))[0].numpy()
    rng = rng[0].numpy()
    gate = finite[0].numpy() & (rng >= F32(cfg.min_range)) & (
        rng <= F32(cfg.max_range))
    with np.errstate(all="ignore"):
        xy = (np.clip((x * x).astype(F32), 0, 1e10).astype(F32)
              + np.clip((y * y).astype(F32), 0, 1e10).astype(F32)).astype(F32)
        s = np.sqrt(xy.astype(np.float64)).astype(F32)
        n_az, drop = cfg.n_azimuth, cfg.elevation_mode == "drop"
        az_t = pk.edge_table(pk.azimuth_edges(n_az))
        el_t = pk.edge_table(pk.elevation_edges(cfg))
        n_el = len(el_t)
        ta, te = atan2_guess(y, x), atan2_guess(z, s)
        az_scale = F32(F32(n_az) * F32(0.159154943))
        el_scale = F32(F32(cfg.n_elevation) / F32(cfg.elevation_span))
        ga = np.floor(((ta + F32(math.pi)).astype(F32) * az_scale)
                      .astype(F32))
        ge = np.floor(((te - F32(cfg.elevation_min)).astype(F32) * el_scale)
                      .astype(F32))
        ga = np.clip(np.nan_to_num(ga), 0, n_az).astype(int)
        ge = np.clip(np.nan_to_num(ge) + drop, 0, n_el).astype(int)
        na = (np.abs(x) + np.abs(y)).astype(F32)
        ne = (np.abs(z) + s).astype(F32)
        la = edge_walk(y, x, ga, n_az, az_t, (na * F32(2.0 ** -40)).astype(F32))
        la = np.where((na > F32(2.0 ** -60)) & ~((la == 0) & ~(y < 0))
                      & ~((la == n_az) & ~(y > 0)), la, -1)
        le = edge_walk(z, s, ge, n_el, el_t, (ne * F32(2.0 ** -40)).astype(F32))
        le = np.where(ne > F32(2.0 ** -60), le, -1)
    deferred = gate & ((la < 0) | (le < 0))
    row = le - 1 if drop else le
    kept = gate & ~deferred & ~(drop & ((le == 0) | (le == n_el)))
    pix = np.where(kept, row * n_az + np.where(la == n_az, 0, la), -1)
    pix = np.where(deferred, np.where(valid, exact, -1), pix)
    return pix, rng, deferred


def kernel_model(points, cfg, plan, grid=264):
    """(B, N, 3|4) points -> (images, scratch after the call, deferred
    count), the kernel's steps in numpy."""
    b, n = points.shape[:2]
    n_pix = cfg.n_elevation * cfg.n_azimuth
    inf = np.float32(np.inf)
    scratch = np.full((b, 4 * plan.n_quads), inf, F32)
    seen = np.zeros((b, n), int)
    n_deferred = 0
    # CTAs take chunks in turn; the order cannot change a min
    for c in range(b * plan.chunks):
        sb = c // plan.chunks
        lo = (c - sb * plan.chunks) * plan.per_chunk
        hi = min(lo + plan.per_chunk, n)
        seen[sb, lo:hi] += 1
        pix, rng, deferred = point_pixels(points[sb, lo:hi], cfg)
        n_deferred += int(deferred.sum())
        hit = pix >= 0
        np.minimum.at(scratch[sb], pix[hit], rng[hit])
    assert np.all(seen == 1)              # every point in one chunk
    # decode: thread t of CTA k takes 16-byte words k·512 + t + j·grid·512
    total = b * plan.n_quads
    w = (np.arange(grid * 512)[None, :]
         + np.arange(-(-total // (grid * 512)))[:, None] * grid * 512)
    w = w[w < total]
    assert np.array_equal(np.sort(w), np.arange(total))   # each word once
    words = scratch.reshape(total, 4)
    sb, q = np.divmod(w, plan.n_quads)
    pix = 4 * q[:, None] + np.arange(4)[None, :]
    keep = pix < n_pix                    # the scalar stores of a last word
    out = np.full((b, n_pix), np.nan, F32)
    vals = words[w]
    out[np.broadcast_to(sb[:, None], pix.shape)[keep], pix[keep]] = np.where(
        np.isinf(vals), F32(0), vals)[keep]
    words[w] = inf
    assert not np.isnan(out).any()        # every pixel written
    return (out.reshape(b, cfg.n_elevation, cfg.n_azimuth), scratch,
            n_deferred)


def _scan(order, b, n, seed):
    rng = np.random.default_rng(seed)
    if order == "random":
        az = rng.uniform(-np.pi, np.pi, (b, n))
        el = rng.uniform(np.deg2rad(-26.0), np.deg2rad(3.0), (b, n))
        r = rng.uniform(0.5, 90.0, (b, n))
        pts = np.stack([r * np.cos(el) * np.cos(az),
                        r * np.cos(el) * np.sin(az), r * np.sin(el),
                        rng.uniform(0, 1, r.shape)], axis=-1).astype(F32)
    else:       # rings flattened ring-major, as a sensor's file holds them
        per_ring = -(-n // 16)
        rings = make_structured_ring_scans(b, 16, per_ring, CLIP, seed=seed)
        pts = np.ascontiguousarray(rings.reshape(b, -1, 4)[:, :n])
    for i in range(b):
        pts[i, n - rng.integers(1, n // 8):] = np.nan     # padding tail
    return pts


@pytest.mark.parametrize("order", ["random", "sweep"])
@pytest.mark.parametrize("chunks", [1, 3, 8, 16])
def test_kernel_model_matches_plain_and_jax(chunks, order):
    """Chunks of about 1000 points (N not a multiple of the chunk), B = 1
    and 3, clip and drop, 3 and 4 channels: bit-equal to the plain
    version; nudged off the bin edges, equal to JAX's
    ``project_points_batch``."""
    n = 1000 * chunks + 1
    pts = _scan(order, 3, n, seed=chunks)
    for cfg in (CLIP, DROP):
        for b in (1, 3):
            for c in (4, 3):
                x = np.ascontiguousarray(pts[:b, :, :c])
                plan = pk.LaunchPlan(chunks, -(-n // chunks),
                                     -(-cfg.n_elevation * cfg.n_azimuth // 4))
                got, scratch, _ = kernel_model(x, cfg, plan)
                want = tri.project_points_batch_plain(torch.from_numpy(x),
                                                      cfg).numpy()
                np.testing.assert_array_equal(got, want)
                assert np.all(np.isinf(scratch))
        nudged = nudge_points(pts, cfg)
        plan = pk.LaunchPlan(chunks, -(-n // chunks), 5760)
        got, _, _ = kernel_model(nudged, cfg, plan)
        jcfg = jri.ProjectionConfig(*cfg)
        want = np.asarray(jri.project_points_batch(jnp.asarray(nudged), jcfg))
        assert (want > 0).sum() > 500
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)


@pytest.mark.parametrize("case", ["all_nan_scan", "no_points"])
def test_kernel_model_degenerate_batches(case):
    """An all-NaN scan beside a real one gives an empty image; a batch of
    scans with no points gives zeros (the kernel still decodes)."""
    n = 0 if case == "no_points" else 2501
    pts = _scan("random", 2, max(n, 2501), seed=7)[:, :n].copy()
    if case == "all_nan_scan":
        pts[1] = np.nan
    plan = pk.launch_plan(2, n, CLIP.n_elevation * CLIP.n_azimuth)
    got, scratch, _ = kernel_model(pts, CLIP, plan)
    want = tri.project_points_batch_plain(torch.from_numpy(pts), CLIP)
    np.testing.assert_array_equal(got, want.numpy())
    assert not got[-1].any() and np.all(np.isinf(scratch))
    if case == "all_nan_scan":
        assert got[0].any()


@pytest.mark.parametrize("cfg", [CLIP, DROP], ids=["clip", "drop"])
def test_points_on_edges_and_axes(cfg):
    """Points at the bin edges (float64 angles), on the axes, on z = 0 and
    at the origin: every bin the walk confirms is the plain version's, the
    undecidable ones (an angle on the axis edge, z = 0 against a band that
    ends at 0 degrees) go to the float64 path, and the image is bit-equal."""
    pts = chip_smoke._edge_points(20000, 3, cfg)
    pix, _, deferred = point_pixels(pts, cfg)
    t = torch.from_numpy(pts[None])
    rng, azimuth, elevation, finite = tri._spherical(t)
    valid = tri._valid_mask(rng, elevation, finite, cfg)[0].numpy()
    exact = (tri.elevation_bins(elevation, cfg) * cfg.n_azimuth
             + tri.azimuth_bins(azimuth, cfg.n_azimuth))[0].numpy()
    np.testing.assert_array_equal(pix, np.where(valid, exact, -1))
    assert 0 < deferred.sum() < len(pts) // 4
    plan = pk.launch_plan(1, len(pts), cfg.n_elevation * cfg.n_azimuth)
    got, _, n_def = kernel_model(pts[None], cfg, plan)
    np.testing.assert_array_equal(got, tri.project_points_batch_plain(
        t, cfg).numpy())
    assert n_def == deferred.sum()


def test_random_points_are_rarely_deferred():
    """On a full-density scan in random order the walk confirms every
    point's bins (the float64 path is for points within 2^-40 of an edge)."""
    pts = _scan("random", 1, 133_632, seed=11)[0]
    _, _, deferred = point_pixels(pts, CLIP)
    assert deferred.sum() == 0


@pytest.mark.parametrize("cfg", [
    CLIP, DROP, tri.ProjectionConfig(n_elevation=16),
    tri.ProjectionConfig(n_elevation=20, n_azimuth=361,
                         elevation_range_deg=(-15.0, 15.0))],
    ids=["clip64", "drop", "clip16", "odd"])
def test_edge_tables_step_where_the_plain_bins_step(cfg):
    """Within 3 ulps of every edge, the number of edges at or below a
    float32 angle is the plain version's bin (azimuth: the last level wraps
    to bin 0; drop mode: levels 0 and E+1 are outside the band), and the
    table's hi + lo pairs are the cosine and sine of each edge's rounding
    boundary to 2^-48."""
    az = pk.azimuth_edges(cfg.n_azimuth)
    keys = (pk._keys(az)[:, None] + np.arange(-3, 4)[None]).ravel()
    theta = pk._floats(keys)
    theta = theta[np.abs(theta) <= F32(math.pi)]
    level = (pk._keys(theta)[:, None] >= pk._keys(az)[None]).sum(axis=1)
    np.testing.assert_array_equal(
        pk._azimuth_bin(torch.from_numpy(theta), cfg.n_azimuth).numpy(),
        np.where(level == cfg.n_azimuth, 0, level))
    el = pk.elevation_edges(cfg)
    e = pk._floats((pk._keys(el)[:, None] + np.arange(-3, 4)[None]).ravel())
    level = (pk._keys(e)[:, None] >= pk._keys(el)[None]).sum(axis=1)
    bins = tri.elevation_bins(torch.from_numpy(e), cfg).numpy()
    if cfg.elevation_mode == "drop":
        band = (e >= F32(cfg.elevation_min)) & (e <= F32(cfg.elevation_max))
        np.testing.assert_array_equal((level >= 1) & (level <= len(el) - 1),
                                      band)
        np.testing.assert_array_equal(level[band] - 1, bins[band])
    else:
        np.testing.assert_array_equal(level, bins)
    for edges in (az, el):
        table = pk.edge_table(edges).astype(np.float64)
        mid = (pk._floats(pk._keys(edges) - 1).astype(np.float64)
               + edges.astype(np.float64)) / 2
        assert np.abs(table[:, 0] + table[:, 1] - np.cos(mid)).max() < 2e-15
        assert np.abs(table[:, 2] + table[:, 3] - np.sin(mid)).max() < 2e-15


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_edge_side_error_bound(scale):
    """The double-word side test is off the exact u cos m - v sin m by at
    most 2^-23 |result| + 2^-45 (|u| + |v|), the bound its 2^-40 margin
    rests on (exact value in extended precision)."""
    rng = np.random.default_rng(int(scale * 1000))
    u = (rng.uniform(-1, 1, 200_000) * scale).astype(F32)
    v = (rng.uniform(-1, 1, 200_000) * scale).astype(F32)
    m = rng.uniform(-np.pi, np.pi, u.size)
    c = np.stack([np.cos(m), np.sin(m)], axis=1)
    hi = c.astype(F32)
    lo = (c - hi.astype(np.float64)).astype(F32)
    table = np.stack([hi[:, 0], lo[:, 0], hi[:, 1], lo[:, 1]], axis=1)
    got = edge_side(u, v, table).astype(np.longdouble)
    want = (u.astype(np.longdouble) * np.cos(m).astype(np.longdouble)
            - v.astype(np.longdouble) * np.sin(m).astype(np.longdouble))
    bound = (2.0 ** -23 * np.abs(got)
             + 2.0 ** -45 * (np.abs(u) + np.abs(v)).astype(np.longdouble))
    assert np.all(np.abs(got - want) <= bound)


def test_atan2_guess_is_within_2e_6():
    rng = np.random.default_rng(2)
    theta = rng.uniform(-np.pi, np.pi, 500_000)
    r = rng.uniform(0.01, 100.0, theta.size)
    x, y = (r * np.cos(theta)).astype(F32), (r * np.sin(theta)).astype(F32)
    err = np.abs(atan2_guess(y, x).astype(np.float64)
                 - np.arctan2(y.astype(np.float64), x.astype(np.float64)))
    assert np.minimum(err, 2 * np.pi - err).max() < 2e-6


@pytest.mark.parametrize("batch,n", [(1, 133_632), (2, 1000), (8, 133_632),
                                     (64, 131_072), (3, 0)])
def test_launch_plan_per_batch(batch, n):
    """512-point chunks at B = 1 (a full-density scan gives the 264 CTAs of
    the card about one each), 1024 above; the chunks cover each scan."""
    plan = pk.launch_plan(batch, n, 64 * 360)
    assert plan.n_quads == 5760 and plan.per_chunk <= pk.MAX_CHUNK
    assert plan.per_chunk == max(1, min(512 if batch == 1 else 1024, n))
    assert (plan.chunks - 1) * plan.per_chunk < max(n, 1) <= (
        plan.chunks * plan.per_chunk) or n == 0 == plan.chunks


def test_scratch_is_cached_per_device_stream_and_shape():
    cpu = torch.device("cpu")
    scratch, control = pk.scratch_for(cpu, 7, 2, 1440)
    assert pk.scratch_for(cpu, 7, 2, 1440)[0] is scratch
    assert scratch.shape == (2, 5760) and scratch.dtype == torch.int32
    assert bool((scratch == pk.INF_BITS).all())
    assert control.shape == (pk.CONTROL_WORDS,) and not control.any()
    for other in ((cpu, 8, 2, 1440), (cpu, 7, 3, 1440), (cpu, 7, 2, 90)):
        assert pk.scratch_for(*other)[0] is not scratch
    tables = pk.edge_tables(CLIP, cpu)
    assert pk.edge_tables(CLIP, cpu) is tables
    assert tables[0].shape == (360, 4) and tables[1].shape == (63, 4)
    assert pk.edge_tables(DROP, cpu)[1].shape == (65, 4)


def test_bare_relaunch_repeats_the_last_call():
    """``CudaKernel.bare`` replays the last call's arguments, scratch and
    control pointers included; the kernel leaves those as it found them
    (+inf, 0), so a replay does the same work as a wrapper call: the model
    run twice on its own output scratch gives the same image."""
    calls = []
    kernel = _build.CudaKernel("nsc_test_symbol", [])
    kernel.__dict__["_fn"] = lambda *args: calls.append(args) or 0
    scratch, control = pk.scratch_for(torch.device("cpu"), 0, 1, 1440)
    args = (1, 2, scratch.data_ptr(), control.data_ptr())
    kernel(*args)
    kernel.bare()()
    assert calls == [args, args] and kernel.launches == 1
    pts = _scan("sweep", 1, 4001, seed=5)
    plan = pk.launch_plan(1, 4001, 64 * 360)
    first, left, _ = kernel_model(pts, CLIP, plan)
    again, left_again, _ = kernel_model(pts, CLIP, plan)
    np.testing.assert_array_equal(first, again)
    assert np.all(np.isinf(left)) and np.all(np.isinf(left_again))


def test_odd_image_sizes_decode_every_pixel():
    """An image whose pixel count is not a multiple of 4 takes the
    kernel's scalar stores for its last word."""
    cfg = tri.ProjectionConfig(n_elevation=3, n_azimuth=7)
    pts = _scan("random", 2, 3001, seed=9)
    plan = pk.launch_plan(2, 3001, 21)
    assert plan.n_quads == 6
    got, _, _ = kernel_model(pts, cfg, plan, grid=2)
    np.testing.assert_array_equal(got, tri.project_points_batch_plain(
        torch.from_numpy(pts), cfg).numpy())
