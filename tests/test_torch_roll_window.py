"""The roll kernels' design (``csrc/roll_floor.cu``) held on the CPU.

A roll chain of ``probe_kernels.floor_shifts`` (P2) or ``chain_shifts``
(P3) is one circular window of ``L`` elements (``roll_window``). Where it
covers the row (L = W) the kernels take it in one pass per row; they run
the stages on rows that hold a NaN and on every row of a shorter window.
This file holds:

- the window rule: for both schedules, every width 1-4352 and every stage
  count 0-``MAX_STAGES``, the set of offsets the chain reaches (a bit set,
  stage by stage) is exactly [0, L − 1];
- a numpy model of the kernels' algorithm, step for step as the CUDA code
  takes it: on a saturated window (L = W) the row min (P3) or, for P2,
  eight warp spans of a 256-thread CTA walked backwards in 32-lane groups
  with the wrap-around "next index that holds the min"; the stage chain
  on NaN rows and on windows shorter than the row. Held bit for bit
  (``view(int32)``) against ``roll_floor_plain``, ``roll_min_chain_plain``,
  the JAX ``_floor_kernel`` through ``pl.pallas_call(..., interpret=True)``
  and ``_roll_kernel_np``, on inputs with ties, runs of ±0, ±inf, NaN
  rows, widths not a multiple of 4, W = 1 and windows shorter than the row;
- the NaN finding: without the chain, the window argmin of a row that
  holds NaNs differs from the plain version.

Tolerance: none; every comparison is on the int32 bit patterns.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from neural_spectral_codec_torch.ops import probe_kernels as pk
from test_torch_probes import RSP, _roll_kernel_np

torch.set_num_threads(2)

WARPS = 256 // 32                # kThreads / 32 in csrc/roll_floor.cu
INT_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# the window rule
# ---------------------------------------------------------------------------

def _floor_offsets(width, n):
    return [(width - s) % width for s in pk.floor_shifts(width, n)]


@pytest.mark.parametrize("schedule", ["chain", "floor"])
def test_window_rule_every_width_and_stage_count(schedule):
    """The reachable set of a chain is one range, and ``roll_window``'s L
    is its length: ``reach`` holds bit o when some subset of the stages'
    offsets sums to o mod W."""
    offsets_of = {"chain": pk.chain_shifts, "floor": _floor_offsets}[schedule]
    for width in range(1, 4353):
        offs = offsets_of(width, pk.MAX_STAGES)
        full = (1 << width) - 1
        reach = 1
        for n in range(pk.MAX_STAGES + 1):
            window, saturated = pk.roll_window(offs[:n], width)
            assert reach == (1 << window) - 1, (width, n)
            assert saturated == (window == width)
            if n < pk.MAX_STAGES:
                o = offs[n]
                reach |= ((reach << o) | (reach >> (width - o))) & full


def test_roll_window_raises_and_plans():
    with pytest.raises(ValueError, match="no single range"):
        pk.roll_window([1, 3], 10)
    with pytest.raises(ValueError, match="outside"):
        pk.roll_window([10], 10)
    assert pk.roll_window([], 7) == (1, False)
    assert pk.roll_window([0, 0], 1) == (1, True)
    # P3 at 16 stages over 2112: 1 + 2047 + 31 = 2079 < W
    window, shifts = pk._chain_plan(2112, 16)
    assert window == 2079 and list(shifts) == pk.chain_shifts(2112, 16)
    assert pk._chain_plan(2112, 16) is pk._chain_plan(2112, 16)   # cached
    assert pk._chain_plan(2112, 64)[0] == 2112
    assert pk._floor_plan(2176, 12)[0] == 2176
    assert pk._floor_plan(2176, 4)[0] == 16
    assert pk._floor_plan(768, 6)[0] == 64
    assert pk._floor_plan(1, 3)[0] == 1 and pk._floor_plan(64, 0)[0] == 1
    assert list(pk._floor_plan(2176, 40)[1]) == pk.floor_shifts(2176, 40)


# ---------------------------------------------------------------------------
# numpy model of the kernels
# ---------------------------------------------------------------------------

def _first_min_saturated(a, b, n_arrays):
    """``first_min_saturated``: per row, out[i] = a[j] + b[j] (b[i] with one
    array), j the first index at or after i, circularly, holding the min;
    eight warp spans of 32-lane groups, each walked backwards with the
    carry of the spans after it or the row's first index."""
    rows, width = a.shape
    eq = a == np.fmin.reduce(a, axis=1, keepdims=True)   # fminf skips NaN
    groups = -(-width // 32)
    per = -(-groups // WARPS)
    spans = [(min(w * per, groups), min(min(w * per, groups) + per, groups))
             for w in range(WARPS)]
    first = np.full((rows, WARPS), INT_MAX)
    for w, (g0, g1) in enumerate(spans):
        span = eq[:, 32 * g0:min(32 * g1, width)]
        if span.shape[1]:
            first[:, w] = np.where(span.any(1), 32 * g0 + span.argmax(1),
                                   INT_MAX)
    wrap = first.min(1)
    j = np.empty((rows, width), np.int64)
    for w, (g0, g1) in enumerate(spans):
        later = first[:, w + 1:].min(1) if w + 1 < WARPS else wrap
        carry = np.where(later == INT_MAX, wrap, later)
        for g in reversed(range(g0, g1)):
            for i in reversed(range(32 * g, min(32 * g + 32, width))):
                carry = np.where(eq[:, i], i, carry)
                j[:, i] = carry
    r = np.arange(rows)[:, None]
    return a[r, j] + (b[r, j] if n_arrays == 2 else b)


def _chain(a, b, shifts, n_arrays):
    """``roll_chain``: the stages themselves."""
    for s in shifts:
        a_s = np.roll(a, s, axis=1)
        take = a_s < a
        if n_arrays == 2:
            b = np.where(take, np.roll(b, s, axis=1), b)
        a = np.where(take, a_s, a)
    return a, b


def model_roll_floor(x, y, n_stages, n_arrays, chain_on_nan=True):
    """What ``roll_floor_kernel`` computes, row by row: the saturated first
    minimum, or the stages themselves on a row that holds a NaN (unless
    ``chain_on_nan`` is off) and on every row of a shorter window."""
    width = x.shape[1]
    window, shifts = pk._floor_plan(width, n_stages)
    chain = np.isnan(x).any(1) if chain_on_nan else np.zeros(len(x), bool)
    chain |= window < width
    out = np.empty_like(x)
    if (~chain).any():
        out[~chain] = _first_min_saturated(x[~chain], y[~chain], n_arrays)
    if chain.any():
        a, b = _chain(x[chain], y[chain], list(shifts), n_arrays)
        out[chain] = a + b
    return out


def model_roll_min_chain(x, n_stages):
    """What ``roll_min_chain_kernel`` computes, row by row: the row min of
    x + 1, or the stages on a row that holds a NaN and on every row of a
    shorter window."""
    width = x.shape[1]
    window, shifts = pk._chain_plan(width, n_stages)
    y = x + np.float32(1.0)
    chain = np.isnan(x).any(1) | (window < width)
    out = np.repeat(y.min(axis=1, keepdims=True), width, axis=1)
    if chain.any():
        out[chain] = _chain(y[chain], None, list(shifts), 1)[0]
    return out


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _rows(kind, n_rows, width, seed):
    """(x, y) float32: x with many ties (steps of 1/8 in [−1, 2]) plus,
    by kind, runs of ±0 as the row min, ±inf (an all +inf row, an all −inf
    row), or NaN rows; y uniform (tells the winning index apart)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 25, (n_rows, width)) / 8 - 1).astype(np.float32)
    if kind == "zeros":
        x = np.abs(x) + np.float32(0.125)
        for r in range(n_rows):
            for k in rng.integers(0, width, 3):
                run = np.array([0.0, -0.0, -0.0, 0.0, -0.0], np.float32)
                x[r, k:k + 5] = run[:width - k]
        x[:, ::11] = -0.0
    elif kind == "inf":
        x[:, rng.integers(0, width, max(width // 50, 1))] = np.inf
        x[1::3, rng.integers(0, width, max(width // 80, 1))] = -np.inf
        x[0] = np.inf
        if n_rows > 2:
            x[2] = -np.inf
    elif kind == "nan":
        x[1, rng.integers(0, width)] = np.nan
        if n_rows > 5:
            x[5, ::97] = np.nan
            x[n_rows - 1, :] = np.nan
    y = rng.uniform(-1, 1, (n_rows, width)).astype(np.float32)
    y[:, ::13] = -0.0
    return x, y


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


FLOOR_CASES = [
    (2176, 12, 2, "ties"), (2176, 12, 1, "zeros"), (2176, 40, 2, "inf"),
    (768, 10, 2, "nan"), (2176, 4, 2, "ties"), (2176, 8, 1, "zeros"),
    (768, 6, 2, "inf"), (2175, 12, 2, "nan"), (2175, 11, 2, "ties"),
    (1000, 10, 2, "zeros"), (100, 5, 1, "inf"), (7, 2, 2, "zeros"),
    (3, 3, 1, "nan"), (1, 3, 2, "ties"), (64, 0, 2, "ties"),
]


@pytest.mark.parametrize("width,n_stages,n_arrays,kind", FLOOR_CASES)
def test_floor_model_matches_plain(width, n_stages, n_arrays, kind):
    x, y = _rows(kind, 16, width, seed=width + n_stages)
    got = model_roll_floor(x, y, n_stages, n_arrays)
    want = pk.roll_floor(torch.from_numpy(x), torch.from_numpy(y), n_stages,
                         n_arrays)
    np.testing.assert_array_equal(_bits(got), want.view(torch.int32).numpy())


CHAIN_CASES = [
    (2112, 64, "ties"), (2112, 16, "ties"), (2112, 5, "zeros"),
    (2112, 64, "nan"), (2110, 16, "inf"), (2110, 64, "zeros"),
    (256, 64, "ties"), (257, 9, "inf"), (100, 6, "nan"), (3, 4, "zeros"),
    (1, 2, "ties"), (64, 0, "inf"),
]


@pytest.mark.parametrize("width,n_stages,kind", CHAIN_CASES)
def test_chain_model_matches_plain_and_numpy(width, n_stages, kind):
    x, _ = _rows(kind, 16, width, seed=3 * width + n_stages)
    got = _bits(model_roll_min_chain(x, n_stages))
    plain = pk.roll_min_chain(torch.from_numpy(x), n_stages)
    np.testing.assert_array_equal(got, plain.view(torch.int32).numpy())
    np.testing.assert_array_equal(got, _bits(_roll_kernel_np(x, n_stages)))


@pytest.mark.parametrize("width,n_stages,n_arrays,kind", [
    (2176, 12, 2, "zeros"), (768, 6, 2, "nan"), (2175, 11, 1, "inf")])
def test_floor_model_matches_pallas(width, n_stages, n_arrays, kind):
    x, y = _rows(kind, 8, width, seed=7 * width + n_stages)
    kernel = functools.partial(RSP._floor_kernel, n_stages=n_stages,
                               n_arrays=n_arrays, p=width)
    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((8, width), jnp.float32),
        interpret=True)(x, y))
    got = model_roll_floor(x, y, n_stages, n_arrays)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_nan_rows_are_not_windows():
    """P2 at 12 stages over 2176 with a NaN every 97 columns: a NaN never
    replaces anything and blocks what would pass through it, so the
    NaN-skipping window argmin differs from the chain; the kernels run the
    stages on such rows."""
    x, y = _rows("ties", 4, 2176, seed=97)
    x[:, ::97] = np.nan
    want = pk.roll_floor_plain(torch.from_numpy(x), torch.from_numpy(y), 12,
                               2).view(torch.int32).numpy()
    window_only = _bits(model_roll_floor(x, y, 12, 2, chain_on_nan=False))
    assert (window_only != want).any(axis=1).all()
    np.testing.assert_array_equal(_bits(model_roll_floor(x, y, 12, 2)), want)
