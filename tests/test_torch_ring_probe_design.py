"""The ring-fold probe kernel's design (``csrc/ring_probe.cu``) held on the
CPU.

The kernel splits a row into one contiguous chunk of whole quads per thread
(``per = 4 · ceil(ceil(P / 4) / threads)`` points, loaded straight into
registers; 256 threads a CTA at B = 8, 512 at B = 1), summarises
each chunk as {first valid bin, last valid bin, wrap events inside}, and
runs ONE exclusive scan of the summaries: inside each warp by shuffles
(lane ``l`` takes ``combine(s[l − off], s[l])`` for off = 1, 2, 4, 8, 16,
then the value of lane ``l − 1``), then the same over the warps' totals,
each warp's prefix combined in front of its lanes'. Each chunk then walks
its points from that start state and scatters the kept ranges by a min on
their uint32 bits into a wpad-wide row (+inf → 0 on the way out).

This file holds a numpy model of exactly that, step for step, and checks:

- the model bit-equal (``view(uint32)``) to ``ring_fold_rows_plain`` at
  widths 1, 31, 768, 2175 and 2176, n_folds 1-3, for 256 and 512
  threads, on rows with leading, interior and trailing invalid runs,
  all-invalid rows, rows of repeated wraps and random rows with repeated
  bins and keys outside [0, n_azim);
- the scan's start state of every chunk against its definition on the
  row: the last valid bin before the chunk and the wrap events before it;
- ``combine`` associative, with {-1, -1, 0} its identity;
- the stand-ins: ``scan`` off means every chunk starts after bin −1 (and
  counts only the events inside earlier chunks), ``fold`` off means every
  chunk starts at fold 0; ``write`` off clamps +inf to the largest finite
  float;
- one full-variant case against the JAX ``_variant_kernel`` through
  ``pl.pallas_call(..., interpret=True)``;
- the rows ``chip_smoke.py`` checks the kernel on (``_probe_key_rows``):
  they hold what their cases name, and the model takes them as the plain
  version does.

Tolerance: none; every comparison is on the bit patterns.
"""

import functools
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from neural_spectral_codec_torch.ops import probe_kernels as pk  # noqa: E402
from test_torch_probes import CFG, ROWS, RSP, WIDTH, _probe_keys  # noqa: E402

torch.set_num_threads(2)

N_AZIM = 360
INF_BITS = np.uint32(0x7F800000)
MAX_FINITE_BITS = np.uint32(0x7F7FFFFF)
IDENT = (-1, -1, 0)                      # Summary{-1, -1, 0}
THREADS = (256, 512)                     # kFewThreads, kManyThreads
K_PER = 12                               # kPer: most points of a chunk


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def chunks(width, threads):
    """(lo, hi) of each thread's chunk, as the kernel computes them: whole
    quads, ``per = 4 · ceil(ceil(P / 4) / threads)`` points a thread."""
    per = 4 * -(-(-(-width // 4)) // threads)
    out = []
    for t in range(threads):
        lo = min(t * per, width)
        out.append((lo, min(lo + per, width)))
    return out


def bin_of(k, n_azim=N_AZIM):
    return int(k) if 0.0 <= k < n_azim else -1


def combine(l, r, fold=True):
    """The kernel's combine<kScan, kFold>: with fold off the events stay 0
    (with scan off first and last are -1 already)."""
    return (l[0] if l[0] >= 0 else r[0], r[1] if r[1] >= 0 else l[1],
            l[2] + r[2] + int(r[0] >= 0 and r[0] < l[1]) if fold else 0)


def summarise(bins, lo, hi, scan=True, fold=True):
    first, last, ev = -1, -1, 0
    for k in bins[lo:hi]:
        if k >= 0:
            if scan and first < 0:
                first = k
            if fold:
                ev += int(k < last)          # last < 0 before the first
            last = k
    return (first, last if scan else -1, ev)


def warp_exclusive(vals, fold=True):
    """The kernel's warp_exclusive on 32 lanes."""
    s = list(vals)
    for off in (1, 2, 4, 8, 16):
        s = [combine(s[l - off], s[l], fold) if l >= off else s[l]
             for l in range(32)]
    return [IDENT] + s[:31]


def block_exclusive(sums, fold=True):
    """The exclusive scan of one summary per thread: in warp order, then
    across the warps' totals (warp 0 scans them, lanes past the last warp
    holding the identity)."""
    n_warps = len(sums) // 32
    pres, totals = [], []
    for w in range(n_warps):
        lanes = sums[32 * w:32 * w + 32]
        pre = warp_exclusive(lanes, fold)
        pres.append(pre)
        totals.append(combine(pre[31], lanes[31], fold))
    before = warp_exclusive(totals + [IDENT] * (32 - n_warps), fold)
    return [combine(before[w], pres[w][l], fold) for w in range(n_warps)
            for l in range(32)]


def chunk_starts(bins, threads, scan=True, fold=True):
    """(folds, prev) each thread's walk starts from."""
    if not (scan or fold):
        return [(0, -1)] * threads
    sums = [summarise(bins, lo, hi, scan, fold)
            for lo, hi in chunks(len(bins), threads)]
    return [(p[2], p[1]) for p in block_exclusive(sums, fold)]


def model_rows(key, vals, n_folds, threads, skip=()):
    """The kernel on (N, P) float32 keys and ranges → (N, wpad) float32;
    ``skip`` may hold ``scan``, ``fold``, ``write`` (``scatter`` off is a
    race in the kernel and has no model)."""
    assert "scatter" not in skip
    n, width = key.shape
    wpad = pk.folded_width(N_AZIM, n_folds)
    out = np.zeros((n, wpad), np.uint32)
    bits = np.ascontiguousarray(vals, np.float32).view(np.uint32)
    for r in range(n):
        bins = [bin_of(k) for k in key[r].tolist()]
        starts = chunk_starts(bins, threads, "scan" not in skip,
                              "fold" not in skip)
        row = np.full(wpad, INF_BITS, np.uint32)
        for (lo, hi), (folds, prev) in zip(chunks(width, threads), starts):
            for i in range(lo, hi):
                k = bins[i]
                if k < 0:
                    continue
                folds += int(k < prev)       # prev < 0 before the first
                prev = k
                if folds <= n_folds - 1:
                    slot = folds * N_AZIM + k
                    row[slot] = min(row[slot], bits[r, i])
        if "write" in skip:
            out[r] = np.minimum(row, MAX_FINITE_BITS)
        else:
            out[r] = np.where(row == INF_BITS, np.uint32(0), row)
    return out.view(np.float32)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _rows(width, seed):
    """(6, width) float32 keys and ranges: repeated wraps (2.6 turns) with
    scattered holes; a leading invalid run; an interior one; a trailing
    one; no valid point; random bins with repeats and keys outside
    [0, 360) (360, 400, −3, NaN). Ranges in [0.5, 80) with exact ties and
    zeros, +inf on most invalid points."""
    rng = np.random.default_rng(seed)
    turns = rng.uniform(0, N_AZIM) + np.linspace(0, 2.6 * N_AZIM, width)
    sweep = np.floor(turns) % N_AZIM
    key = np.tile(sweep, (6, 1)).astype(np.float32)
    key[0, rng.integers(0, width, width // 7 + 1)] = -1.0
    key[1, : (2 * width) // 5] = -1.0
    key[2, width // 3: (2 * width) // 3] = -1.0
    key[3, width - width // 4:] = -1.0
    key[4] = -1.0
    key[5] = rng.integers(0, 40, width)
    key[5, rng.integers(0, width, width // 9 + 1)] = rng.choice(
        np.array([360.0, 400.0, -3.0, np.nan], np.float32), width // 9 + 1)
    vals = (rng.integers(1, 160, (6, width)) / 2).astype(np.float32)
    vals[:, ::11] = 0.0
    invalid = ~((key >= 0) & (key < N_AZIM))
    vals[invalid & (rng.uniform(size=key.shape) < 0.8)] = np.inf
    return key, vals


def _plain(key, vals, n_folds):
    return pk.ring_fold_rows_plain(torch.from_numpy(key),
                                   torch.from_numpy(vals), N_AZIM,
                                   n_folds).numpy()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,threads", list(itertools.product(
    (1, 31, 768, 2175, 2176), THREADS)))
def test_model_matches_plain(width, threads):
    key, vals = _rows(width, seed=width + threads)
    for n_folds in (1, 2, 3):
        got = model_rows(key, vals, n_folds, threads)
        want = _plain(key, vals, n_folds)
        assert got.shape == want.shape == (6, pk.folded_width(N_AZIM,
                                                              n_folds))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    if width > 100:
        assert (want[0] > 0).sum() > 100 and not want[4].any()


def test_chunk_split():
    """Contiguous chunks of whole quads that tile the row, the last ones
    short or empty: at 2176 × 256 chunks of 12 (182 threads busy), at
    2176 × 512 (B = 1) chunks of 8. A chunk lives in ``kPer`` = 12
    registers, so the entry point takes 512 threads for rows wider than
    12 · 256 and refuses rows wider than 12 · 512."""
    for width, threads in itertools.product((1, 31, 768, 2175, 2176),
                                            THREADS):
        cs = chunks(width, threads)
        assert cs[0][0] == 0 and cs[-1][1] == width
        assert all(a[1] == b[0] for a, b in zip(cs, cs[1:]))
        assert all(lo % 4 == 0 or lo == width for lo, _ in cs)
        assert max(hi - lo for lo, hi in cs) <= 4 * -(-width // 4)
    assert sum(hi > lo for lo, hi in chunks(2176, 256)) == 182
    assert chunks(2176, 256)[0] == (0, 12)
    assert chunks(2176, 512)[0] == (0, 8)
    for threads in THREADS:
        widest = K_PER * threads
        assert max(hi - lo for lo, hi in chunks(widest, threads)) == K_PER
        assert max(hi - lo for lo, hi in chunks(widest + 1, threads)) > K_PER


@pytest.mark.parametrize("threads", THREADS)
def test_scan_gives_each_chunk_its_prefix(threads):
    """Every chunk's start state, full and with each stand-in, against
    its definition on the row."""
    key, _ = _rows(2175, seed=7)
    for bins in ([bin_of(k) for k in row.tolist()] for row in key):
        cs = chunks(len(bins), threads)
        local_ev = [summarise(bins, lo, hi)[2] for lo, hi in cs]
        full = chunk_starts(bins, threads)
        no_scan = chunk_starts(bins, threads, scan=False)
        no_fold = chunk_starts(bins, threads, fold=False)
        for t, (lo, _) in enumerate(cs):
            valid = [k for k in bins[:lo] if k >= 0]
            events = sum(b < a for a, b in zip(valid, valid[1:]))
            prev = valid[-1] if valid else -1
            assert full[t] == (events, prev)
            # scan off: every chunk starts after bin -1, with only the
            # events inside the chunks before it
            assert no_scan[t] == (sum(local_ev[:t]), -1)
            # fold off: every chunk starts at fold 0
            assert no_fold[t] == (0, prev)
        assert chunk_starts(bins, threads, False, False) == [(0, -1)] * threads


def test_combine_is_associative():
    rng = np.random.default_rng(0)

    def draw():
        first, last = sorted(rng.integers(-1, 360, 2).tolist())
        if rng.uniform() < 0.3:
            return IDENT
        if first < 0:
            first = last
        return (first, last if first >= 0 else -1,
                int(rng.integers(0, 4)) if first >= 0 else 0)

    for _ in range(3000):
        a, b, c = draw(), draw(), draw()
        assert combine(combine(a, b), c) == combine(a, combine(b, c))
        assert combine(IDENT, a) == a == combine(a, IDENT)


def test_stand_ins_differ_and_stay_finite():
    """With scan or fold off the rows differ from the full kernel's on
    rows that wrap across chunks; with write off empty slots read the
    largest finite float; every variant is finite."""
    key, vals = _rows(768, seed=3)
    full = model_rows(key, vals, 2, 256)
    for skip in (("scan",), ("fold",), ("scan", "fold"), ("write",),
                 ("scan", "fold", "write")):
        got = model_rows(key, vals, 2, 256, skip)
        assert np.isfinite(got).all()
        if "scan" in skip or "fold" in skip:
            assert not np.array_equal(got, full), skip
    clamped = model_rows(key, vals, 2, 256, ("write",)).view(np.uint32)
    empty = full == 0                    # no point, or a range of 0
    assert np.isin(clamped[empty], [0, MAX_FINITE_BITS]).all()
    assert (clamped[empty] == MAX_FINITE_BITS).sum() > 100
    np.testing.assert_array_equal(clamped[~empty],
                                  full[~empty].view(np.uint32))


@functools.lru_cache(maxsize=1)
def _pallas_case(n_folds=2):
    """(key, vals, rows) of the JAX probe's full variant (nothing off,
    full stage depths) in interpret mode, on its own 64 × 256 block."""
    key, vals = _probe_keys(n_folds, seed=11)
    wpad = pk.folded_width(CFG.n_azimuth, n_folds)
    full = max((WIDTH - 1).bit_length(), 1)
    full_e = max((n_folds * CFG.n_azimuth - 1).bit_length(), 1)
    variant = functools.partial(
        RSP._variant_kernel, p=WIDTH, n_azim=CFG.n_azimuth, n_folds=n_folds,
        wpad=wpad, skip=frozenset(), bounds=(full, full, full, full_e))
    want = np.asarray(pl.pallas_call(
        variant, out_shape=jax.ShapeDtypeStruct((ROWS, wpad), jnp.float32),
        interpret=True)(key, vals))
    return np.asarray(key), np.asarray(vals), want


@pytest.mark.parametrize("threads", THREADS)
def test_model_matches_pallas_variant(threads):
    key, vals, want = _pallas_case()
    got = model_rows(key, vals, 2, threads)
    assert (want > 0).sum() > 3000
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("threads", THREADS)
def test_chip_smoke_case_rows(threads):
    """Rows 4 mod 8 hold no valid point, rows 5 mod 8 wrap at every valid
    point after the first; the model equals the plain version on all."""
    key, vals = chip_smoke._probe_key_rows(16, 301, seed=5)
    valid = (key >= 0) & (key < N_AZIM)
    assert not valid[4].any() and not valid[12].any()
    k5 = key[5][valid[5]]
    assert len(k5) == 301 and (np.diff(k5)[k5[1:] != 359] < 0).all()
    assert np.isinf(vals[~valid]).all() and np.isfinite(vals[valid]).all()
    for n_folds in (1, 2, 3):
        np.testing.assert_array_equal(
            model_rows(key, vals, n_folds, threads).view(np.uint32),
            _plain(key, vals, n_folds).view(np.uint32))
