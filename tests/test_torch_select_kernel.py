"""Kernel S (``csrc/select.cu``, ``training/select_kernel.py``) on the
CPU: its plain version against ``torch.sort(stable=True)``, JAX's
``jnp.argsort`` (the order the miner's "semi-hard" strategy takes: −0
equal to +0, every NaN last) and numpy's stable sort of the order-mapped
keys, on rows with many ties, ±0, ±inf and NaN; and a numpy model of the
kernel's cluster regime (slices, the cross-rank histogram sums, the rank
that walks; its digits, slice widths and thread layout read from the
CUDA source) against the plain version, bit for bit. Small shapes: up to
64 × 4,099, and 3 rows of the miner's 100,003.

The kernel runs only on a card (``chip_smoke.py`` phase 7k holds it
against ``select_plain`` there, bit for bit)."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402

from neural_spectral_codec_torch.training import (  # noqa: E402
    select_kernel as sk)

torch.set_num_threads(2)
SRC = (REPO / "neural_spectral_codec_torch" / "csrc" / "select.cu").read_text()
S_SRC = {m[1]: int(m[2]) for m in re.finditer(
    r"constexpr int (k\w+) = (\d+);", SRC)}
LEVELS = np.array([-np.inf, -1.5, -0.0, 0.0, 0.25, 7.0, np.inf, np.nan],
                  np.float32)


def _rows(kind: str, rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((rows, n)).astype(np.float32)
    if kind == "ties":          # few values, each repeated many times
        return rng.choice(np.array([0.5, 0.25, 3.0, 0.125], np.float32),
                          (rows, n))
    if kind == "w1":            # the miner's block: sums, +inf outside
        x = rng.random((rows, n)).astype(np.float32) * 4
        x[rng.random((rows, n)) < 0.6] = np.inf
        return x
    x = LEVELS[rng.integers(0, len(LEVELS) - (kind == "special_no_nan"),
                            (rows, n))]
    return x


def _places(rows: int, n: int, seed: int) -> np.ndarray:
    k = np.random.default_rng(seed + 100).integers(0, n, rows)
    k[0], k[-1] = 0, n - 1
    return k.astype(np.int32)


def keys_u32(x: np.ndarray) -> np.ndarray:
    """The kernel's unsigned keys: bits ^ 0x80000000 for v > 0, ~bits for
    v < 0, 0x80000000 for ±0, 0xffffffff for NaN."""
    u = x.view(np.uint32)
    k = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    k = np.where(x == 0, np.uint32(0x80000000), k)
    return np.where(np.isnan(x), np.uint32(0xFFFFFFFF), k)


def stable_model(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """numpy's stable argsort of the unsigned keys at place k."""
    order = np.argsort(keys_u32(x), axis=1, kind="stable")
    kk = np.clip(k, 0, x.shape[1] - 1)
    return order[np.arange(len(x)), kk]


@pytest.mark.parametrize("kind", ["random", "ties", "w1", "special",
                                  "special_no_nan"])
@pytest.mark.parametrize("rows,n", [(64, 257), (7, 4099), (3, 1), (2, 5)])
def test_plain_equals_the_stable_order(kind, rows, n):
    """``select_plain`` is the stable order of the order-mapped keys at
    each row's place, and equal to ``torch.sort(stable=True)`` and to
    ``jnp.argsort`` (JAX's reference order)."""
    x = _rows(kind, rows, n, seed=rows * 31 + n)
    k = _places(rows, n, seed=n)
    got = sk.select_plain(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, stable_model(x, k))
    assert got.dtype == np.int32
    ref = torch.sort(torch.from_numpy(x), dim=1, stable=True).indices
    np.testing.assert_array_equal(got, ref.numpy()[np.arange(rows), k])
    ref = np.asarray(jnp.argsort(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(got, ref[np.arange(rows), k])


def test_zero_signs_nan_and_places_out_of_range():
    """−0 equal to +0 (column order among the zeros), +inf after every
    finite value, every NaN last in column order, whatever its sign;
    places below 0 and past the row are clamped."""
    x = np.array([[0.0, np.nan, -0.0, np.inf, -np.nan, 1.0, -np.inf, 0.0]],
                 np.float32)
    order = [6, 0, 2, 7, 5, 3, 1, 4]
    for place, col in enumerate(order):
        got = sk.select_plain(torch.from_numpy(x),
                              torch.tensor([place], dtype=torch.int32))
        assert int(got[0]) == col, place
    for place, col in ((-3, 6), (8, 4), (1000, 4)):
        got = sk.select_plain(torch.from_numpy(x), torch.tensor([place]))
        assert int(got[0]) == col


def layout_model(n: int) -> int:
    """The cluster width for rows of n columns, 0 for the streaming
    regime, from ``csrc/select.cu``'s slice widths and cluster limit: the
    rule its header states."""
    two, one, cmax = S_SRC["kSliceTwo"], S_SRC["kSliceOne"], S_SRC[
        "kClusterMax"]
    if -(-n // two) <= cmax:
        return -(-n // two)
    return cmax if -(-n // one) <= cmax else 0


def _choose(tot: np.ndarray, rank: int) -> tuple:
    """The digit whose bucket holds ``rank`` (a prefix count over the
    bins, as the block scan of the threads' kOwn bins gives it) and the
    entries below it."""
    cum = np.cumsum(tot)
    digit = int(np.searchsorted(cum, rank, side="right"))
    return digit, int(cum[digit] - tot[digit])


def cluster_model(x: np.ndarray, k: np.ndarray, ctas=None,
                  phases=(0,)) -> np.ndarray:
    """Kernel S's cluster regime as ``csrc/select.cu`` runs it. A row of n
    columns is cut into C = ``ctas`` (default ``layout_model(n)``)
    contiguous slices of ⌈n / C⌉ columns, rank order = column order; each
    rank holds its slice at a 16-byte phase (``phases``, cycled over the
    ranks: the column's place in a float4 of shared memory). Each digit
    pass (11, 11, 10 bits from the top) builds one histogram a rank of the
    entries matching the digits chosen so far; the cluster's totals are
    the ranks' histograms added in rank order, and the digit whose bucket
    holds the place is chosen from them (a bucket of one ends the passes).
    A bucket of one entry chosen by a pass after the first is answered by
    the column that pass noted for the bin in the rank holding it. Else
    each rank's count in the bucket is exchanged, the rank whose prefix of
    counts holds the place walks its slice alone: each thread counts the
    matches in its run of ⌈quads / kThreads⌉ consecutive float4s, a prefix
    over the threads places the runs, and the thread whose run holds the
    place walks it. With one CTA and phase 0 the passes are those of the
    streaming regime too."""
    threads = S_SRC["kThreads"]
    assert S_SRC["kPasses"] == 3 and S_SRC["kBins"] == 2048
    shifts, widths = (21, 10, 0), (11, 11, 10)
    out = np.zeros(len(x), np.int64)
    for r in range(len(x)):
        n = x.shape[1]
        c = ctas or layout_model(n)
        assert c >= 1
        width = -(-n // c)
        bounds = [(min(i * width, n), min(i * width + width, n))
                  for i in range(c)]
        keys = [keys_u32(x[r, lo:hi]).astype(np.uint64) for lo, hi in bounds]
        rank = int(np.clip(k[r], 0, n - 1))
        prefix = mask = 0
        found = None
        for p, (shift, bits) in enumerate(zip(shifts, widths)):
            dmask = (1 << bits) - 1
            hists = [np.bincount(((kk[(kk & mask) == prefix] >> shift)
                                  & dmask).astype(np.int64), minlength=2048)
                     for kk in keys]
            tot = np.zeros(2048, np.int64)
            for h in hists:                       # ranks in order
                tot += h
            digit, below = _choose(tot, rank)
            found = [int(h[digit]) for h in hists]
            prefix |= digit << shift
            mask |= dmask << shift
            rank -= below
            if tot[digit] == 1:
                break
        if tot[digit] == 1 and p > 0:             # the noted column
            owner = found.index(1)
            (col,) = np.flatnonzero((keys[owner] & mask) == prefix)
            out[r] = bounds[owner][0] + col
            continue
        starts = np.cumsum([0] + found)
        owner = int(np.searchsorted(starts, rank, side="right")) - 1
        assert starts[owner] <= rank < starts[owner + 1]
        rank -= int(starts[owner])
        lo, hi = bounds[owner]
        phase = phases[owner % len(phases)]
        hits = np.zeros(phase + (hi - lo) + 3, bool)
        hits[phase:phase + hi - lo] = (keys[owner] & mask) == prefix
        quads = hits[:len(hits) // 4 * 4].reshape(-1, 4)
        per = -(-len(quads) // threads)
        runs = [quads[t * per:(t + 1) * per].reshape(-1)
                for t in range(threads)]
        cnt = np.array([run.sum() for run in runs])
        t = int(np.searchsorted(np.cumsum(cnt), rank, side="right"))
        assert t < threads, "the walk ran past its slice"
        left = rank - int(np.cumsum(cnt)[t] - cnt[t])
        e = t * per * 4 + np.flatnonzero(runs[t])[left]
        out[r] = lo + e - phase
    return out


@pytest.mark.parametrize("kind", ["random", "ties", "w1", "special"])
def test_radix_model_equals_plain(kind):
    """The kernel's radix select (the cluster model at the layout's own
    width, one slice at this n, which is also the streaming regime's
    passes) gives ``select_plain``'s column on every row: 16 rows of 4,099
    columns, rows of many ties (buckets of thousands), the miner's
    +inf-heavy blocks, ±0, ±inf and NaN, places at both ends."""
    x = _rows(kind, 16, 4099, seed=7)
    k = _places(16, 4099, seed=8)
    want = sk.select_plain(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(cluster_model(x, k), want.numpy())


@pytest.mark.parametrize("kind", ["random", "ties", "w1", "special"])
@pytest.mark.parametrize("ctas,phases", [(1, (3,)), (3, (1, 2, 3)),
                                         (8, (2, 0))])
def test_cluster_model_equals_plain(kind, ctas, phases):
    """The cluster regime gives ``select_plain``'s column on every row with
    the rows cut into 1, 3 and 8 slices at every 16-byte phase: the same
    rows as ``test_radix_model_equals_plain``, ties spread over every
    rank."""
    x = _rows(kind, 16, 4099, seed=7)
    k = _places(16, 4099, seed=8)
    want = sk.select_plain(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(cluster_model(x, k, ctas, phases),
                                  want.numpy())


@pytest.mark.parametrize("kind", ["w1", "ties"])
def test_cluster_model_at_the_miners_width(kind):
    """At the miner's row width (100,003 columns: the layout's 4 slices of
    25,001) the cluster model equals ``select_plain`` and the stable
    order's column."""
    x = _rows(kind, 3, 100_003, seed=11)
    k = _places(3, 100_003, seed=12)
    k[1] = int(np.isfinite(x[1]).sum()) // 2      # the miner's place
    assert layout_model(100_003) == 4
    want = sk.select_plain(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(cluster_model(x, k, None, (0, 1, 2, 3)),
                                  want)
    np.testing.assert_array_equal(want, stable_model(x, k))


def test_radix_model_on_close_values():
    """Values a few ulps apart (one digit pass does not separate them) and
    a row whose every entry is equal, cut into 4 slices: the model still
    takes the stable order's column."""
    base = np.float32(1.0)
    x = np.stack([
        base + np.random.default_rng(3).integers(0, 9, 3000).astype(
            np.float32) * np.spacing(base),
        np.full(3000, np.float32(2.5))])
    k = np.array([1500, 2999], np.int32)
    want = sk.select_plain(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(cluster_model(x, k, 4, (1,)), want.numpy())
    assert int(want[1]) == 2999


@pytest.mark.parametrize("ctas", [2, 4, 7])
def test_cluster_model_across_slice_edges_in_a_run_of_ties(ctas):
    """Runs of one value that cross every slice edge, the places inside a
    run on both sides of an edge and at its ends: the rank that walks is
    the one whose prefix of matches holds the place, and the column is
    the stable order's."""
    n = 5003
    width = -(-n // ctas)
    rng = np.random.default_rng(ctas)
    x = rng.random((1, n)).astype(np.float32) + 1
    for e in range(width, n, width):
        x[0, e - 40:e + 40] = np.float32(0.75)      # a run across the edge
    x = np.repeat(x, 8, axis=0)
    cols = np.flatnonzero(x[0] == np.float32(0.75))
    first = int(np.sum(x[0] < np.float32(0.75)))
    k = first + np.array([0, 39, 40, 41, 79, len(cols) // 2 + 1,
                          len(cols) - 1, len(cols)], np.int32)
    want = sk.select_plain(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(cluster_model(x, k, ctas, (2, 1)), want)
    np.testing.assert_array_equal(want[:-1], cols[k[:-1] - first])


def test_model_digits_are_the_sources():
    """``select_layout`` is the rule of ``csrc/select.cu``'s header (its
    slice widths and cluster limit read from the source), both regimes are
    reached, a CTA's shared memory fits the card (2 CTAs an SM at
    kSliceTwo, 1 at kSliceOne), and the model's digits (shifts 21, 10, 0;
    widths 11, 11, 10), threads and walk step are the source's."""
    assert "p == 0 ? 21 : p == 1 ? 10 : 0" in SRC
    assert "p == 2 ? 10 : 11" in SRC
    assert "kStep = kThreads * kPerThread" in SRC
    assert "return (int)sizeof(float) * (slice + kSlack);" in SRC
    assert ("cluster of C = ceil(n / kSliceTwo) CTAs (or 8 when that "
            "exceeds 8)") in SRC
    assert (S_SRC["kThreads"], S_SRC["kPerThread"]) == (512, 4)
    assert (sk.SLICE_TWO, sk.SLICE_ONE, sk.CLUSTER_MAX) == (
        S_SRC["kSliceTwo"], S_SRC["kSliceOne"], S_SRC["kClusterMax"])
    for n in (1, 3, 4099, 25_600, 25_601, 100_000, 100_003, 204_800,
              204_801, 300_000, 438_272, 438_273, 1_000_000):
        c = sk.select_layout(n)
        assert c == layout_model(n), n
        assert (c == 0) == (n > S_SRC["kClusterMax"] * S_SRC["kSliceOne"])
        if c:
            assert -(-n // c) <= (S_SRC["kSliceTwo"] if c < 8
                                  else S_SRC["kSliceOne"])
    assert sk.select_layout(100_000) == 4
    # hist, seen, sums, chosen, found, the mbarrier, alignment
    static = 4 * 2048 + 2 * 2048 + 4 * 16 + 4 * 3 + 4 * 8 + 8 + 128
    dyn = [4 * (S_SRC[w] + S_SRC["kSlack"]) for w in ("kSliceTwo",
                                                       "kSliceOne")]
    assert 2 * (dyn[0] + static + 1024) <= 233_472           # 228 KB an SM
    assert dyn[1] + static <= 232_448                        # 227 KB a CTA


def test_select_on_cpu_is_the_plain_version_and_cuda_raises():
    """``select`` on CPU tensors is ``select_plain``; ``select_cuda``
    refuses CPU tensors, and a CUDA tensor without a card raises."""
    x = torch.from_numpy(_rows("w1", 4, 50, seed=1))
    k = torch.tensor([0, 10, 25, 49], dtype=torch.int32)
    assert torch.equal(sk.select(x, k), sk.select_plain(x, k))
    with pytest.raises(ValueError):
        sk.select_cuda(x, k)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            sk.select(x.to("cuda"), k)
