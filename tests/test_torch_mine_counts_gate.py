"""Kernel M's counts entry (``nsc_mine_counts`` in ``csrc/mine.cu``) on the
CPU: its exact thresholds and its tile gate.

* ``mine_kernel.mask_bounds``: for each threshold t, every float32 s ≥ +0
  within ±4,096 ulps of the derived bound (and +0, +inf, NaN) gives the
  same test as the correctly rounded float32 sqrt: sqrt(s) < t ⇔ s < P,
  sqrt(s) ≥ t ⇔ s ≥ Nlo, sqrt(s) ≤ t ⇔ s ≤ Nhi; and every integer gap
  within ±4,096 of its bound G gives float32(gap) ≥ g ⇔ gap ≥ G. The
  reference sqrt is numpy's float32 sqrt and torch's sqrt in float64
  rounded once: both are correctly rounded, as the card's ``__fsqrt_rn``
  and torch's CUDA sqrt are. (Torch's CPU float32 sqrt is not correctly
  rounded on every value, so it is no reference here.)
* ``mine_kernel.tile_gate`` equals an independent numpy model of the
  kernel's gate, and is sound: no pair of a skipped block is a positive
  or a negative.
* A numpy model of the gated count with the squared thresholds equals
  ``counts_plain`` and the masks' row sums, and ``valid`` equals JAX's
  ``_mine_chunk``'s, on ``synthetic_city`` at ``scale_100k``'s thresholds,
  on pairs placed exactly at each bound inside blocks whose boxes touch
  it, and with NaN positions.

The kernel runs only on a card (``chip_smoke.py`` phase 7k holds it
against ``counts_plain`` there, bit for bit, on the same kinds of data)."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

from neural_spectral_codec_tpu.training import miner as jminer  # noqa: E402
from neural_spectral_codec_torch.experiments.scale_100k import (  # noqa: E402
    synthetic_city)
from neural_spectral_codec_torch.training import (  # noqa: E402
    mine_kernel as mk)

torch.set_num_threads(2)
SRC = (REPO / "neural_spectral_codec_torch" / "csrc" / "mine.cu").read_text()
M_SRC = {m[1]: int(m[2]) for m in re.finditer(
    r"constexpr int (k\w+) = (\d+);", SRC)}
SCALE = (5.0, 30.0, 10.0, 100.0, 30.0)        # scale_100k's thresholds
DEFAULT = (5.0, 30.0, 10.0, 50.0, 30.0)       # the miner's defaults
INF_BITS = 0x7F800000
INT32_MAX = 2**31 - 1
F32 = np.float32


def _bits(v) -> int:
    return int(np.array(v, np.float32).view(np.uint32))


def _floats(bits: np.ndarray) -> np.ndarray:
    return bits.astype(np.uint32).view(np.float32)


def _window(bound) -> np.ndarray:
    """Every float32 in [+0, +inf] within ±4,096 ulps of ``bound`` (of 25
    where the bound is NaN), with +0, +inf and NaN."""
    centre = _bits(25.0) if np.isnan(bound) else _bits(bound)
    b = np.arange(max(centre - 4096, 0), min(centre + 4096, INF_BITS) + 1)
    extra = np.array([0, INF_BITS, 0x7FC00000, 0x7F800001])
    return _floats(np.concatenate([b, extra]))


def _sqrt_np(s: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore"):
        return np.sqrt(s)


def _sqrt_torch(s: np.ndarray) -> np.ndarray:
    return torch.sqrt(torch.from_numpy(s).double()).float().numpy()


SQUARE = F32(7.0) * F32(7.0)
THRESHOLDS = [5.0, 10.0, 100.0, 30.0, 50.0, 7.0,
              float(np.nextafter(F32(7), F32(0))),
              float(np.nextafter(F32(7), F32(8))),
              float(np.sqrt(np.nextafter(SQUARE, F32(0)))),
              float(np.sqrt(np.nextafter(SQUARE, F32(100)))),
              0.1, 1e-20, 1e-45, 1e19, 3e38, 0.0, -0.0, -1.0,
              float("inf"), float("nan")]


@pytest.mark.parametrize("t", THRESHOLDS)
def test_squared_bounds_give_the_sqrt_tests(t):
    """For every float32 s ≥ +0 within ±4,096 ulps of each bound, +0, +inf
    and NaN: sqrt(s) < t ⇔ s < sqrt_least(t), sqrt(s) ≥ t ⇔ s ≥
    sqrt_least(t), sqrt(s) ≤ t ⇔ s ≤ sqrt_greatest(t), with both correctly
    rounded sqrts (they agree on every s here); thresholds at and next to
    perfect squares, 0, −0, below 0, tiny, huge, +inf and NaN."""
    t32 = F32(t)
    low, high = mk.sqrt_least(t), mk.sqrt_greatest(t)
    assert low.dtype == np.float32 and high.dtype == np.float32
    for bound in (low, high):
        s = _window(bound)
        r = _sqrt_np(s)
        np.testing.assert_array_equal(r.view(np.uint32),
                                      _sqrt_torch(s).view(np.uint32))
        with np.errstate(invalid="ignore"):
            np.testing.assert_array_equal(s < low, r < t32)
            np.testing.assert_array_equal(s >= low, r >= t32)
            np.testing.assert_array_equal(s <= high, r <= t32)
    if t32 == t32 and t32 >= 0:           # the bounds are the tight ones
        assert np.sqrt(low) >= t32 and (low == 0 or np.sqrt(
            np.nextafter(low, F32(0))) < t32)
        assert np.sqrt(high) <= t32 and (high == np.inf or np.sqrt(
            _floats(np.array([_bits(high) + 1]))[0]) > t32)


GAPS = [30.0, 0.0, -1.0, 0.5, 29.5, 30.5, 1.0, float(2**24 + 1),
        16_777_217.5, 1e9, float(2**31), float(2**31 + 256), float("inf"),
        float("nan")]


@pytest.mark.parametrize("g", GAPS)
def test_gap_bound_gives_the_float_test(g):
    """For every gap 0 .. 2³¹ − 2 within ±4,096 of G = gap_least(g) (and
    0 .. 4,096): float32(gap) ≥ g ⇔ gap ≥ G; ``mask_bounds`` gives max(G,
    1), which is the same test with the kernel's gap > 0."""
    big = mk.gap_least(g)
    gaps = np.unique(np.concatenate([
        np.arange(max(big - 4096, 0), min(big + 4096, INT32_MAX - 1) + 1),
        np.arange(0, 4097)])).astype(np.int64)
    with np.errstate(invalid="ignore"):
        want = gaps.astype(np.float32) >= F32(g)
    np.testing.assert_array_equal(gaps >= big, want)
    b = mk.mask_bounds((5.0, g, 10.0, 50.0, g))
    assert b.pos_gap == b.neg_gap == max(big, 1)
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(gaps >= b.pos_gap, want & (gaps > 0))


def test_mask_bounds_of_the_miners_thresholds():
    """The bounds the miner's thresholds give (float32 rounding of the
    thresholds first): s < 24.999998 is a positive, 10 m ≤ d ≤ 100 m is
    99.99999 ≤ s ≤ 10,000, and the gaps' 30."""
    b = mk.mask_bounds(SCALE)
    assert b == mk.MaskBounds(float(np.nextafter(F32(25), F32(0))),
                              float(np.nextafter(F32(100), F32(0))),
                              10_000.0, 30, 30)
    assert b.pos_s == float(mk.sqrt_least(5.0))


# ---------------- the tile gate ----------------

def _box(v: np.ndarray) -> tuple:
    """min and max a column, NaN where the column holds a NaN."""
    nan = np.isnan(v).any(axis=0)
    lo = np.where(nan, np.nan, np.nanmin(np.where(np.isnan(v), np.inf, v),
                                          axis=0)).astype(np.float32)
    hi = np.where(nan, np.nan, np.nanmax(np.where(np.isnan(v), -np.inf, v),
                                          axis=0)).astype(np.float32)
    return lo, hi


def gate_model(positions: np.ndarray, start: int, count: int,
               params) -> np.ndarray:
    """The kernel's gate, written apart from ``tile_gate``: per (kBA-anchor
    group, kBJ-frame tile) the boxes, the least and greatest rounded
    differences per coordinate, their squares summed as the pair test sums
    them, and skip = s_lo ≥ P and (s_hi < Nlo or s_lo > Nhi)."""
    ba, bj = M_SRC["kBA"], M_SRC["kBJ"]
    b = mk.mask_bounds(tuple(params))
    n = len(positions)
    keep = np.ones((-(-count // ba), -(-n // bj)), bool)
    with np.errstate(invalid="ignore", over="ignore"):
        for g in range(keep.shape[0]):
            amin, amax = _box(positions[start + g * ba:
                                        start + min(g * ba + ba, count)])
            for t in range(keep.shape[1]):
                fmin, fmax = _box(positions[t * bj:t * bj + bj])
                dlo, dhi = amin - fmax, amax - fmin
                low = np.where(dlo > 0, dlo, np.where(
                    dhi < 0, -dhi, np.where(np.isnan(dlo) | np.isnan(dhi),
                                            np.nan, 0))).astype(np.float32)
                high = np.maximum(np.abs(dlo), np.abs(dhi))
                s_lo = (low[0] * low[0] + low[1] * low[1]) + low[2] * low[2]
                s_hi = ((high[0] * high[0] + high[1] * high[1])
                        + high[2] * high[2])
                keep[g, t] = not (s_lo >= F32(b.pos_s) and (
                    s_hi < F32(b.neg_lo_s) or s_lo > F32(b.neg_hi_s)))
    return keep


def masks_np(positions: np.ndarray, start: int, count: int, params):
    """The masks with the correctly rounded sqrt, as ``chunk_masks``."""
    a = np.arange(start, start + count)
    diff = positions[a][:, None, :] - positions[None, :, :]
    sq = diff * diff
    with np.errstate(invalid="ignore", over="ignore"):
        d = np.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])
        gap = np.abs(a[:, None] - np.arange(len(positions))[None, :])
        fgap = gap.astype(np.float32)
        p = [F32(v) for v in params]
        pos = (d < p[0]) & (fgap >= p[1]) & (gap > 0)
        neg = (d >= p[2]) & (d <= p[3]) & (fgap >= p[4]) & (gap > 0)
    return pos, neg


def gated_counts(positions: np.ndarray, start: int, count: int, params):
    """The counts entry's count: per block the gate, then in the blocks it
    keeps s against the squared bounds and the gap against the integer
    ones (no sqrt, no int-to-float); where the least gap between the
    block's anchors and frames reaches both gap bounds, s alone."""
    ba, bj = M_SRC["kBA"], M_SRC["kBJ"]
    b = mk.mask_bounds(tuple(params))
    keep = gate_model(positions, start, count, params)
    n = len(positions)
    a = np.arange(start, start + count)
    diff = positions[a][:, None, :] - positions[None, :, :]
    sq = diff * diff
    with np.errstate(invalid="ignore", over="ignore"):
        s = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        gap = np.abs(a[:, None] - np.arange(n)[None, :])
        s_pos = s < F32(b.pos_s)
        s_neg = (s >= F32(b.neg_lo_s)) & (s <= F32(b.neg_hi_s))
    far = np.zeros_like(keep)
    for g in range(keep.shape[0]):
        a_first, a_last = start + g * ba, start + min(g * ba + ba, count) - 1
        for t in range(keep.shape[1]):
            j_first, j_last = t * bj, min(t * bj + bj, n) - 1
            least = (j_first - a_last if j_first > a_last else
                     a_first - j_last if a_first > j_last else 0)
            far[g, t] = least >= max(b.pos_gap, b.neg_gap)
    far = np.repeat(np.repeat(far, ba, 0), bj, 1)[:count, :n]
    pos = s_pos & (far | (gap >= b.pos_gap))
    neg = s_neg & (far | (gap >= b.neg_gap))
    tested = np.repeat(np.repeat(keep, ba, 0), bj, 1)[:count, :n]
    return (pos & tested).sum(1), (neg & tested).sum(1), keep, pos, neg


def _city(n=4000):
    return synthetic_city(n, dim=8)[1][:, :3, 3].astype(np.float32)


def _exact_pair(bound) -> tuple:
    """(dx, dy) with (dx·dx + dy·dy) rounded exactly ``bound``."""
    bound = F32(bound)
    d = np.sqrt(bound)
    for _ in range(4000):
        d = np.nextafter(d, F32(0))
        rest = F32(bound - d * d)
        if rest <= 0:
            continue
        e = np.sqrt(rest)
        for e in (np.nextafter(np.nextafter(e, F32(0)), F32(0)),
                  np.nextafter(e, F32(0)), e, np.nextafter(e, F32(9)),
                  np.nextafter(np.nextafter(e, F32(9)), F32(9))):
            if d * d + e * e == bound:
                return d, e
    raise AssertionError(f"no pair sums to {bound}")


def _at_bounds(params) -> np.ndarray:
    """128 anchors at the origin (frames 0-127) and one 128-frame tile a
    probe distance d along x (and one along x and y), d every float32
    within ±3 ulps of each threshold, and tiles whose sum of squares is
    each squared bound exactly and one ulp either side of it: each tile's
    box touches the anchors' at exactly that distance, so its pairs sit
    at, just inside and just outside each bound; one tile holds a NaN
    position."""
    ds = []
    for t in (params[0], params[2], params[3]):
        d = F32(t)
        for _ in range(3):
            d = np.nextafter(d, F32(0))
        for _ in range(7):
            ds.append(d)
            d = np.nextafter(d, F32(np.inf))
    tiles = [np.zeros((128, 3), np.float32)]
    for d in ds:
        tiles.append(np.tile(np.array([d, 0, 0], np.float32), (128, 1)))
        e = F32(d / np.sqrt(F32(2)))
        tiles.append(np.tile(np.array([e, e, 0], np.float32), (128, 1)))
    b = mk.mask_bounds(tuple(params))
    for bound in (b.pos_s, b.neg_lo_s, b.neg_hi_s):
        for s in (np.nextafter(F32(bound), F32(0)), F32(bound),
                  np.nextafter(F32(bound), F32(np.inf))):
            dx, dy = _exact_pair(s)
            tiles.append(np.tile(np.array([dx, 0, dy], np.float32),
                                 (128, 1)))
    nan = np.tile(np.array([F32(params[3]), 0, 0], np.float32), (128, 1))
    nan[5, 1] = np.nan
    tiles.append(nan)
    return np.concatenate(tiles)


CASES = {
    "city": lambda: (_city(), 1500, 512, SCALE),
    "city_default": lambda: (_city(), 3100, 300, DEFAULT),
    "at_bounds": lambda: (_at_bounds(SCALE), 0, 128, SCALE),
    "at_bounds_default": lambda: (_at_bounds(DEFAULT), 0, 128, DEFAULT),
    "nan_anchor": lambda: _nan_anchor(),
}


def _nan_anchor():
    p = _city(3000)
    p[1700, 2] = np.nan                # an anchor
    p[40, 0] = np.nan                  # a frame of a far tile
    return p, 1650, 256, SCALE


@pytest.mark.parametrize("case", list(CASES))
def test_gate_model_is_tile_gate_and_sound(case):
    """``tile_gate`` is the numpy model of the kernel's gate; every block
    it skips holds no positive and no negative (the masks of the correctly
    rounded sqrt), and every block holding a NaN position is tested."""
    positions, start, count, params = CASES[case]()
    keep = gate_model(positions, start, count, params)
    got = mk.tile_gate(torch.from_numpy(positions), start, count,
                       mk.mask_bounds(params)).numpy()
    np.testing.assert_array_equal(got, keep)
    pos, neg = masks_np(positions, start, count, params)
    ba, bj = M_SRC["kBA"], M_SRC["kBJ"]
    any_mask = pos | neg
    for g, t in zip(*np.nonzero(~keep)):
        assert not any_mask[g * ba:g * ba + ba, t * bj:t * bj + bj].any()
    nan = np.isnan(positions).any(1)
    for g in range(keep.shape[0]):
        if nan[start + g * ba:start + min(g * ba + ba, count)].any():
            assert keep[g].all()
    for t in range(keep.shape[1]):
        if nan[t * bj:t * bj + bj].any():
            assert keep[:, t].all()
    if case.startswith("city"):
        assert 0 < keep.mean() < 0.9        # the gate skips blocks here


@pytest.mark.parametrize("case", list(CASES))
def test_gated_count_equals_counts_plain(case):
    """The gated, squared-threshold count equals ``counts_plain`` and the
    sqrt masks' row sums, anchor by anchor, with the same masks pair by
    pair; on the at-bounds layouts positives and negatives are counted
    on both sides of every bound."""
    positions, start, count, params = CASES[case]()
    cpos, cneg, keep, pos, neg = gated_counts(positions, start, count,
                                              params)
    want = mk.counts_plain(torch.from_numpy(positions), start, count,
                           tuple(float(v) for v in params), tile=96)
    np.testing.assert_array_equal(cpos, want.count_pos.numpy())
    np.testing.assert_array_equal(cneg, want.count_neg.numpy())
    np.testing.assert_array_equal(want.valid.numpy(), (cpos > 0) & (cneg > 0))
    spos, sneg = masks_np(positions, start, count, params)
    np.testing.assert_array_equal(pos, spos)
    np.testing.assert_array_equal(neg, sneg)
    assert cneg.sum() > 0
    if case.startswith("at_bounds"):
        # pairs exactly at each squared bound and one ulp either side,
        # counted or not as the sqrt tests say
        b = mk.mask_bounds(tuple(params))
        a = np.arange(start, start + count)
        d = positions[a][:, None, :] - positions[None, :, :]
        sq = d * d
        with np.errstate(invalid="ignore"):
            s = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        for bound in (b.pos_s, b.neg_lo_s, b.neg_hi_s):
            for v in (np.nextafter(F32(bound), F32(0)), F32(bound),
                      np.nextafter(F32(bound), F32(np.inf))):
                assert (s == v).sum() >= 128 * 128
        assert (spos & (s == F32(b.pos_s))).sum() == 0
        assert (spos & (s == np.nextafter(F32(b.pos_s), F32(0)))).any()
        assert (sneg & (s == F32(b.neg_lo_s))).any()
        assert not (sneg & (s == np.nextafter(F32(b.neg_lo_s),
                                              F32(0)))).any()
        assert (sneg & (s == F32(b.neg_hi_s))).any()
        assert not (sneg & (s == np.nextafter(F32(b.neg_hi_s),
                                              F32(np.inf)))).any()


@pytest.mark.parametrize("start,count", [(1500, 512), (0, 300),
                                         (3700, 300)])
def test_gated_count_valid_equals_jax(start, count):
    """On ``synthetic_city`` at the miner's default thresholds, ``valid``
    of the gated count equals the ``valid`` of JAX's ``_mine_chunk``
    ("random", on the CPU), and JAX's drawn positives and negatives lie
    inside the squared-threshold masks."""
    positions = _city()
    cdfs = np.zeros((len(positions), 4), np.float32)
    cpos, cneg, _, pos, neg = gated_counts(positions, start, count,
                                           DEFAULT)
    jp, jn, jv = jminer._mine_chunk(
        positions, cdfs, jax.random.key(3), np.asarray(DEFAULT, np.float32),
        np.int32(start), count, "random")
    jv = np.asarray(jv)
    np.testing.assert_array_equal(jv, (cpos > 0) & (cneg > 0))
    rows = np.nonzero(jv)[0]
    assert len(rows) > 50
    assert pos[rows, np.asarray(jp)[rows]].all()
    assert neg[rows, np.asarray(jn)[rows]].all()


def test_gate_pairs_counts_the_kept_blocks():
    """``gate_pairs``' kept pairs are the anchors × frames of the blocks
    ``tile_gate`` keeps, split by ``split_frames``; at most all pairs."""
    positions = _city()
    start, count, splits = 1500, 300, 5
    got = mk.gate_pairs(torch.from_numpy(positions), start, count, SCALE,
                        splits)
    keep = gate_model(positions, start, count, SCALE)
    rows = np.minimum(128, count - 128 * np.arange(keep.shape[0]))
    cols = np.minimum(128, len(positions) - 128 * np.arange(keep.shape[1]))
    kept = int((keep * rows[:, None] * cols[None, :]).sum())
    assert got["kept"] == kept == sum(got["per_split"])
    assert got["pairs"] == count * len(positions) > kept > 0
    assert len(got["per_split"]) == splits


def test_gate_and_bounds_are_the_sources():
    """The kernel's skip test, its bound on |d|, its pair test and its
    rule for the tiles beyond both gap bounds are the ones the models
    above hold (read from ``csrc/mine.cu``), and its block shape is the
    models'."""
    assert ("return s_lo >= b.pos_s && (s_hi < b.neg_lo_s || s_lo > "
            "b.neg_hi_s);") in SRC
    assert "if (dlo > 0.0f) return dlo;" in SRC
    assert "if (dhi < 0.0f) return -dhi;" in SRC
    assert "const bool pos = s < bnd.pos_s;" in SRC
    assert "const bool neg = s >= bnd.neg_lo_s && s <= bnd.neg_hi_s;" in SRC
    assert "cp[i] += pos && gap >= bnd.pos_gap;" in SRC
    assert "cn[i] += neg && gap >= bnd.neg_gap;" in SRC
    assert "if (gap_min >= max(bnd.pos_gap, bnd.neg_gap))" in SRC
    assert (mk.ANCHORS_PER_CTA, mk.ROWS_PER_TILE) == (M_SRC["kBA"],
                                                      M_SRC["kBJ"])
