"""Kernel Q (``csrc/query.cu``, ``retrieval/query_kernel.py``) on the CPU:
its plain version, which ``retriever.query_math`` runs on CPU tensors,
against JAX's ``_query_kernel`` and ``_query_batch_kernel`` (W₁ over
float32 rows and over uint16 codes, L2; Q = 1 and 3; with and without the
spatial filter; k ≤ 9 and one k above ``K_MAX``); its bits under another
chunking of the queries; ties, rows at ``min_d`` ± 1 ulp, ``size`` 0 and
NaN; the kernel's summation order (numpy models of the lanes, the
recursive halving and the butterfly, and of the group kernel's split
of (query, row) sums over warps and lanes, against ``lane_sums``) and its
selection (a numpy model of the per-warp lists and the merge's bound and
bisection, constants read from the CUDA source) against ``smallest_k``;
and the binding's checks, which raise before anything is launched.

Shapes: 500 rows of 160 bins (a few thousand for the large k). Distances
within ``DIST_RTOL`` of JAX's (and ``DIST_ATOL``, that of the rows' unit
scale: the frameworks sum in other orders), indices equal. The kernel
runs only on a card: ``chip_smoke.py`` holds it to ``query_plain`` there,
bit for bit."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402

from neural_spectral_codec_tpu.retrieval.retriever import (  # noqa: E402
    _query_batch_kernel, _query_kernel)
from neural_spectral_codec_torch.retrieval import (  # noqa: E402
    query_kernel as qk)
from neural_spectral_codec_torch.retrieval.retriever import (  # noqa: E402
    dequantize_rows, query_math, quantize_cdf, smallest_k)
from neural_spectral_codec_torch.ops.wasserstein import (  # noqa: E402
    histogram_cdf)

torch.set_num_threads(2)

BINS, N, K = 160, 500, 9
DIST_RTOL = 2e-5
DIST_ATOL = DIST_RTOL * 1.0
MIN_D = 25.0
SRC = (REPO / "neural_spectral_codec_torch" / "csrc" / "query.cu").read_text()
Q_SRC = {m[1]: int(m[2]) for m in re.finditer(
    r"constexpr int (k\w+) = (\d+);", SRC)}
CASES = [("wasserstein", "float32"), ("wasserstein", "uint16"),
         ("l2", "float32")]


def _data(metric, storage, n=N, seed=0):
    """Stored rows (as the retriever stores them), positions, histograms."""
    rng = np.random.default_rng(seed)
    h = rng.random((n, BINS)).astype(np.float32) ** 4
    h /= h.sum(axis=1, keepdims=True)
    pos = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    th = torch.from_numpy(h)
    if metric == "l2":
        rows = th
    else:
        cdf = histogram_cdf(th, 1e-8)
        rows = quantize_cdf(cdf) if storage == "uint16" else cdf
    return rows, torch.from_numpy(pos), h, rng


def _copy_row(rows, dst, src):
    """rows[dst] = rows[src]; uint16 codes through an int16 view."""
    v = rows.view(torch.int16) if rows.dtype == torch.uint16 else rows
    v[dst] = v[src]


def _jax_rows(rows):
    if rows.dtype == torch.uint16:
        return jnp.asarray(rows.view(torch.int16).numpy().view(np.uint16))
    return jnp.asarray(rows.numpy())


def _queries(h, pos, rng, n_q, min_d):
    src = rng.choice(len(h) - 40, n_q, replace=False)
    q = (h[src] + 0.2 * rng.random((n_q, BINS)).astype(np.float32)
         / BINS).astype(np.float32)
    qp = np.concatenate([pos.numpy()[src] + 1.0,
                         np.full((n_q, 1), min_d, np.float32)], axis=1)
    return q, qp


def _jax(rows, pos, size, q, qp, k, metric):
    """JAX's one-dispatch programs: (Q, k) indices and distances."""
    db, db_pos = _jax_rows(rows), jnp.asarray(pos.numpy())
    if len(q) == 1:
        i, d = _query_kernel(db, db_pos, jnp.int32(size), jnp.asarray(q[0]),
                             jnp.asarray(qp[0]), k, metric)
        return np.asarray(i)[None], np.asarray(d)[None]
    i, d = _query_batch_kernel(db, db_pos, jnp.int32(size), jnp.asarray(q),
                               jnp.asarray(qp), k, metric)
    return np.asarray(i), np.asarray(d)


def _port(rows, pos, size, q, qp, k, metric):
    i, d = query_math(rows, pos, size, torch.from_numpy(q),
                      torch.from_numpy(qp), k, metric)
    return i.numpy(), d.numpy()


def _assert_like_jax(got, want, n):
    """Indices equal where JAX's slot is finite; masked slots: the port's
    real rows, JAX's clipped to n - 1."""
    (gi, gd), (wi, wd) = got, want
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(gi[fin], wi[fin])
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    np.testing.assert_array_equal(np.minimum(gi, n - 1)[~fin], wi[~fin])
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=DIST_RTOL,
                               atol=DIST_ATOL)


@pytest.mark.parametrize("spatial", [False, True], ids=["nofilter", "filter"])
@pytest.mark.parametrize("n_q", [1, 3])
@pytest.mark.parametrize("metric,storage", CASES)
def test_plain_matches_jax(metric, storage, n_q, spatial):
    """``query_math`` on CPU tensors (the plain version) against
    ``_query_kernel`` (Q = 1) and ``_query_batch_kernel`` (Q = 3), at the
    database's size and below it."""
    rows, pos, h, rng = _data(metric, storage, seed=n_q + 3 * spatial)
    q, qp = _queries(h, pos, rng, n_q, MIN_D if spatial else 0.0)
    for size in (N, N - 37):
        got = _port(rows, pos, size, q, qp, K, metric)
        _assert_like_jax(got, _jax(rows, pos, size, q, qp, K, metric), N)


@pytest.mark.parametrize("metric,storage", CASES)
def test_plain_matches_jax_above_k_max(metric, storage):
    """k = K_MAX + 1 (the card's distance-entry route; the plain version
    is the same function) on 3,000 rows, filter on, size below capacity."""
    n = 3000
    rows, pos, h, rng = _data(metric, storage, n=n, seed=11)
    q, qp = _queries(h, pos, rng, 2, MIN_D)
    k = qk.K_MAX + 1
    got = _port(rows, pos, n - 5, q, qp, k, metric)
    _assert_like_jax(got, _jax(rows, pos, n - 5, q, qp, k, metric), n)


@pytest.mark.parametrize("metric,storage", CASES)
def test_plain_bits_do_not_depend_on_chunking(metric, storage, monkeypatch):
    """One query a chunk (``MAX_TEMP`` cut to one query's temporary) gives
    the bits of the whole batch in one chunk."""
    rows, pos, h, rng = _data(metric, storage, seed=5)
    q, qp = _queries(h, pos, rng, 5, MIN_D)
    want = _port(rows, pos, N - 3, q, qp, K, metric)
    monkeypatch.setattr(qk, "MAX_TEMP", N * BINS)
    got = _port(rows, pos, N - 3, q, qp, K, metric)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))


@pytest.mark.parametrize("metric,storage", CASES)
def test_ties_go_to_the_lower_row(metric, storage):
    """Copies of one row (equal distances) come out by the lower row, and
    rows past ``size`` fill the tail as +inf by the lowest masked rows,
    as ``lax.top_k`` orders them."""
    rows, pos, h, rng = _data(metric, storage, seed=7)
    copies = [40, 3, 250, 17]
    for r in copies[1:]:
        _copy_row(rows, r, copies[0])
    q = h[copies[0]][None].copy()
    qp = np.zeros((1, 4), np.float32)
    i, d = _port(rows, pos, N, q, qp, K, metric)
    assert list(i[0, :4]) == sorted(copies)
    assert len(set(d[0, :4].view(np.int32))) == 1
    _assert_like_jax((i, d), _jax(rows, pos, N, q, qp, K, metric), N)
    size = 6
    i, d = _port(rows, pos, size, q, qp, K, metric)
    assert np.isinf(d[0, size:]).all() and list(i[0, size:]) == list(
        range(size, K))
    _assert_like_jax((i, d), _jax(rows, pos, size, q, qp, K, metric), N)


@pytest.mark.parametrize("metric,storage", CASES)
def test_min_d_plus_minus_one_ulp(metric, storage):
    """Rows at min_d − 1 ulp, min_d and min_d + 1 ulp from the query
    (along each axis, from a query at the origin and at an offset that
    subtracts exactly): the first masked, the others kept, as JAX's
    ``norm(db_pos − qp) < min_d`` masks them."""
    rows, pos, h, rng = _data(metric, storage, seed=9)
    src = 60
    steps = [np.nextafter(np.float32(MIN_D), np.float32(0)),
             np.float32(MIN_D), np.nextafter(np.float32(MIN_D),
                                             np.float32(1e9))]
    for origin in (np.zeros(3, np.float32),
                   np.array([0.5, -1.0, 2.0], np.float32)):
        placed = []
        for axis in range(3):
            for j, step in enumerate(steps):
                r = 100 + 3 * axis + j
                _copy_row(rows, r, src)
                p = origin.copy()
                p[axis] += step
                assert p[axis] - origin[axis] == step
                pos[r] = torch.from_numpy(p)
                placed.append((r, j > 0))
        q = h[src][None].copy()
        qp = np.concatenate([origin, [MIN_D]])[None].astype(np.float32)
        pos[src] = torch.from_numpy(origin + 100.0)
        i, d = _port(rows, pos, N, q, qp, 12, metric)
        kept = sorted([src] + [r for r, keep in placed if keep])
        assert list(i[0, :len(kept)]) == kept
        assert not {r for r, keep in placed if not keep} & set(i[0])
        _assert_like_jax((i, d), _jax(rows, pos, N, q, qp, 12, metric), N)


@pytest.mark.parametrize("metric,storage", CASES)
def test_size_zero(metric, storage):
    """``size`` 0 (an int and a 0-d int64 tensor): every slot +inf, rows
    0 … k − 1; JAX's slots are +inf too."""
    rows, pos, h, rng = _data(metric, storage, seed=13)
    q, qp = _queries(h, pos, rng, 3, MIN_D)
    for size in (0, torch.tensor(0)):
        i, d = _port(rows, pos, size, q, qp, K, metric)
        assert np.isposinf(d).all()
        np.testing.assert_array_equal(i, np.tile(np.arange(K), (3, 1)))
    want_i, want_d = _jax(rows, pos, 0, q, qp, K, metric)
    assert np.isposinf(want_d).all()


def test_nan_distances_rank_last():
    """A row with a NaN bin has a NaN distance: torch's one NaN, after
    every +inf slot (``smallest_k`` on the canonical NaN)."""
    rows, pos, h, rng = _data("wasserstein", "float32", n=40, seed=17)
    rows[2, 5] = float("nan")
    rows[9, 0] = -float("nan")
    q = h[4][None].copy()
    qp = np.zeros((1, 4), np.float32)
    i, d = _port(rows, pos, 30, q, qp, 40, "wasserstein")
    assert list(i[0, -2:]) == [2, 9]
    assert (d[0, -2:].view(np.int32) == np.int32(0x7FC00000)).all()
    assert np.isposinf(d[0, 28:38]).all()
    assert list(i[0, 28:38]) == list(range(30, 40))


def _halving_model(acc: np.ndarray) -> np.ndarray:
    """The kernel's reduction of (32 lanes, 32 queries) float32 lane sums:
    recursive halving at offsets 16 … 1 (a lane keeps the half of its
    queries its offset bit selects, adds the partner's copy of them), as
    ``halve<32, 16>`` does; returns each lane's final value."""
    v = [list(acc[lane]) for lane in range(32)]
    n, o = 32, 16
    while o >= 1:
        new = []
        for lane in range(32):
            upper = bool(lane & o)
            partner = lane ^ o
            mine = v[lane][n // 2:] if upper else v[lane][:n // 2]
            theirs = v[partner][n // 2:] if upper else v[partner][:n // 2]
            new.append([np.float32(a + b) for a, b in zip(mine, theirs)])
        v, n, o = new, n // 2, o // 2
    return np.array([lane_v[0] for lane_v in v], np.float32)


@pytest.mark.parametrize("bins,unit,metric", [(160, 4, "wasserstein"),
                                              (800, 4, "l2"),
                                              (800, 8, "wasserstein"),
                                              (37, 4, "wasserstein"),
                                              (301, 8, "wasserstein")])
def test_lane_order_model(bins, unit, metric):
    """``lane_sums`` equals a float32 numpy model of the kernel: each lane
    adds its units (l, l + 32, …) element by element from 0, and the
    32 queries' lane sums of a row are reduced by recursive halving, which
    leaves query l on lane l; bit for bit, for 32 queries and rows whose
    width is not a multiple of the unit or of 32 units."""
    rng = np.random.default_rng(bins + unit)
    rows = rng.random((3, bins)).astype(np.float32)
    q = rng.random((32, bins)).astype(np.float32)
    want = qk.lane_sums(torch.from_numpy(rows), torch.from_numpy(q), metric,
                        unit).numpy()
    units = -(-bins // unit)
    for r in range(3):
        acc = np.zeros((32, 32), np.float32)       # (lane, query)
        for lane in range(32):
            for u in range(lane, -(-units // 32) * 32, 32):
                for v in range(unit):
                    e = u * unit + v
                    x = rows[r, e] if e < bins else np.float32(0)
                    y = q[:, e] if e < bins else np.zeros(32, np.float32)
                    t = (x - y).astype(np.float32)
                    t = np.abs(t) if metric == "wasserstein" else t * t
                    acc[lane] = (acc[lane] + t).astype(np.float32)
        got = _halving_model(acc)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want[:, r].view(np.int32))


def _halve(v: np.ndarray, offset: int = 16) -> np.ndarray:
    """``halve<N, offset>`` on (32 lanes, N) float32 values: at each offset
    a lane keeps the half of its values that its offset bit selects and
    adds the partner lane's copy of that half; returns (32, N / 32)."""
    while offset >= 1:
        n = v.shape[1] // 2
        lanes = np.arange(32)
        upper = (lanes & offset) != 0
        partner = v[lanes ^ offset]
        mine = np.where(upper[:, None], v[:, n:], v[:, :n])
        theirs = np.where(upper[:, None], partner[:, n:], partner[:, :n])
        v = (mine + theirs).astype(np.float32)
        offset //= 2
    return v


@pytest.mark.parametrize("mode", ["float32", "uint16", "l2"])
@pytest.mark.parametrize("group", [2, 3, 8, 32])
def test_group_split_model(group, mode):
    """``lane_sums`` equals a float32 numpy model of the group kernel's
    split, bit for bit: a CTA's group cut into query tiles of at most
    ``kTileQ`` queries (1, 2 or 4, queries spread evenly), the warps of a
    tile splitting a round's rows ``kTileR`` a warp; lane l of a warp adds
    to its ``kTileQ`` × ``kTileR`` tile of sums, for each of its units l,
    l + 32, … and each float quad of the unit, each query's quad against
    each row's (a query slot past the tile's queries stays 0); then the 64
    sums a lane are reduced by recursive halving, which leaves lane l the
    sums of slot l / 4 over rows 2 (l % 4) and 2 (l % 4) + 1. Rows of 301
    bins (a last unit cut short) and 32 units past them zero-padded."""
    tq, tr, warps = Q_SRC["kTileQ"], Q_SRC["kTileR"], Q_SRC["kGroupWarps"]
    lanes_a_slot = Q_SRC["kSlotLanes"]
    tiles = 1 if group <= tq else (2 if group <= 2 * tq else 4)
    row_tiles = warps // tiles
    n_rows, bins = tr * row_tiles, 301
    unit = 8 if mode == "uint16" else 4
    metric = "l2" if mode == "l2" else "wasserstein"
    rng = np.random.default_rng(group * 7 + unit)
    q = rng.random((group, bins)).astype(np.float32)
    if mode == "uint16":
        codes = rng.integers(0, 65536, (n_rows, bins)).astype(np.uint16)
        scale = np.float32(1.0 / 65535.0)
        x = codes.astype(np.float32) * scale      # one rounded product
        rows = dequantize_rows(torch.from_numpy(codes.view(np.int16)).view(
            torch.uint16)).numpy()
        np.testing.assert_array_equal(x.view(np.int32), rows.view(np.int32))
    else:
        x = rng.random((n_rows, bins)).astype(np.float32)
        rows = x
    want = qk.lane_sums(torch.from_numpy(rows), torch.from_numpy(q), metric,
                        unit).numpy()                  # (group, n_rows)
    units = -(-bins // unit)
    width = -(-units // 32) * 32 * unit
    xp = np.zeros((n_rows, width), np.float32)
    xp[:, :bins] = x
    qp = np.zeros((group, width), np.float32)
    qp[:, :bins] = q
    got = np.full((group, n_rows), np.nan, np.float32)
    for w in range(warps):
        qt, rt = divmod(w, row_tiles)
        q_lo = qt * group // tiles
        qn = (qt + 1) * group // tiles - q_lo
        rows_w = slice(rt * tr, rt * tr + tr)
        acc = np.zeros((32, tq, tr), np.float32)        # (lane, slot, row)
        for lane in range(32):
            for u in range(lane, width // unit, 32):
                if u >= units:
                    continue                            # adds +0
                for h in range(unit // 4):
                    e = u * unit + 4 * h
                    xq = xp[rows_w, e:e + 4]             # (rows, 4)
                    for s in range(qn):
                        y = qp[q_lo + s, e:e + 4]
                        a = acc[lane, s]
                        for c in range(4):
                            t = (xq[:, c] - y[c]).astype(np.float32)
                            t = np.abs(t) if metric == "wasserstein" else (
                                t * t).astype(np.float32)
                            a = (a + t).astype(np.float32)
                        acc[lane, s] = a
        v = _halve(acc.reshape(32, tq * tr))            # (32, 2)
        for lane in range(32):
            s = lane // lanes_a_slot
            if s >= qn:
                continue
            for t in range(v.shape[1]):
                r = rt * tr + v.shape[1] * (lane % lanes_a_slot) + t
                got[q_lo + s, r] = v[lane, t]
    assert not np.isnan(got).any()                    # every pair held once
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _u64_keys(d: np.ndarray) -> np.ndarray:
    """The kernel's unsigned keys (u(d) << 32) | row."""
    b = d.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return (u << np.uint64(32)) | np.arange(len(d), dtype=np.uint64)


def _merge_model(d: np.ndarray, k: int, warps: int, cap: int):
    """A numpy model of kernel Q's selection for one query's distances:
    row pairs strided over ``warps`` lists (each the k smallest keys its
    warp saw, empty slots ~0), the bound (the k-th smallest of the
    kMergeGroups group minima of the lists' first keys), the gather and,
    past ``cap`` keys, the bisection; returns (rows, distances, kept)."""
    groups, rows = Q_SRC["kMergeGroups"], Q_SRC["kRowsOne"]
    keys = _u64_keys(d)
    none = np.uint64(0xFFFFFFFFFFFFFFFF)
    lists = np.full((warps, k), none, np.uint64)
    for w in range(warps):
        mine = np.concatenate([keys[p * rows:(p + 1) * rows]
                               for p in range(w, -(-len(d) // rows), warps)]
                              or [np.zeros(0, np.uint64)])
        best = np.sort(mine)[:k]
        lists[w, :len(best)] = best
    heads = np.full(groups, none, np.uint64)
    for g in range(min(groups, warps)):
        heads[g] = lists[g::groups, 0].min()
    bound = np.sort(heads)[k - 1]
    flat = lists.ravel()
    kept = int((flat <= bound).sum())
    if kept > cap:
        lo, hi = np.uint64(0), bound
        while True:
            mid = lo + (hi - lo) // np.uint64(2)
            n = int((flat <= mid).sum())
            if n < k:
                lo = mid
            elif n > cap:
                hi = mid
            else:
                bound, kept = mid, n
                break
    top = np.sort(flat[flat <= bound])[:k]
    u = (top >> np.uint64(32)).astype(np.uint32)
    bits = np.where(u & 0x80000000, u ^ 0x80000000, ~u).astype(np.uint32)
    return ((top & np.uint64(0xFFFFFFFF)).astype(np.int64),
            bits.view(np.float32), kept)


@pytest.mark.parametrize("k,warps,cap", [(1, 64, 4096), (10, 64, 4096),
                                         (10, 3, 4096), (128, 64, 4096),
                                         (10, 64, 12), (128, 700, 200)])
def test_merge_model_equals_smallest_k(k, warps, cap):
    """The model of the kernel's per-warp lists, bound, gather and
    bisection (``cap`` cut to force it) selects ``smallest_k``'s rows and
    distances, on distances with ties, +inf rows and a NaN; and, with
    rows a list well above k, the bound keeps few keys on random data (the
    gather's common case)."""
    rng = np.random.default_rng(k + warps)
    d = rng.random(3000).astype(np.float32)
    d[rng.choice(3000, 300, replace=False)] = np.inf
    d[::97] = d[5]
    d[11] = np.nan
    rows, dist, kept = _merge_model(d, k, warps, cap)
    want_d, want_i = smallest_k(torch.from_numpy(d)[None], k)
    np.testing.assert_array_equal(rows, want_i[0].numpy())
    np.testing.assert_array_equal(dist.view(np.int32),
                                  want_d[0].numpy().view(np.int32))
    assert k <= kept <= cap
    if cap == Q_SRC["kMergeCap"] and warps == 64 and k <= 10:
        assert kept <= 4 * k + 8


def test_constants_match_the_source():
    """The binding's constants are the kernel's."""
    assert qk.K_MAX == Q_SRC["kMaxK"]
    assert Q_SRC["kRegK"] <= qk.K_MAX <= Q_SRC["kMergeGroups"]
    assert Q_SRC["kGroup"] == qk.LANES
    assert qk.K_MAX <= Q_SRC["kMergeCap"]
    tq, tr = Q_SRC["kTileQ"], Q_SRC["kTileR"]
    assert Q_SRC["kSlotLanes"] * tq == qk.LANES      # a slot's lanes
    assert Q_SRC["kSlotLanes"] * (tq * tr // qk.LANES) == tr
    assert 4 * tq == Q_SRC["kGroup"] == qk.LANES      # up to 4 query tiles
    assert Q_SRC["kGroupWarps"] % 4 == 0
    assert 2 <= Q_SRC["kMinStages"] <= Q_SRC["kMaxStages"]
    assert qk.unit_elems(torch.float32) == 4
    assert qk.unit_elems(torch.uint16) == 8


def _valid_inputs():
    rows, pos, h, rng = _data("wasserstein", "float32", n=64, seed=1)
    q = torch.from_numpy(h[:2].copy())
    f = torch.zeros((2, 4))
    return rows, pos, q, f


@pytest.mark.parametrize("fault", ["cpu", "rows_dtype", "rows_strided",
                                   "pos_dtype", "filters_shape", "size_dtype",
                                   "k_zero", "k_past_rows", "l2_uint16"])
def test_wrapper_raises_before_any_launch(fault):
    """``query_cuda`` refuses a CPU tensor, a wrong dtype, a
    non-contiguous row buffer, a wrong shape and an out-of-range k with
    ``ValueError``; nothing is launched (the counters stay, and no kernel
    library is built: this host has no nvcc)."""
    rows, pos, q, f = _valid_inputs()
    size, k, metric = 64, 5, "wasserstein"
    if fault == "rows_dtype":
        rows = rows.double()
    elif fault == "rows_strided":
        rows = torch.cat([rows, rows], dim=1)[:, ::2]
    elif fault == "pos_dtype":
        pos = pos.double()
    elif fault == "filters_shape":
        f = torch.zeros((2, 3))
    elif fault == "size_dtype":
        size = torch.tensor(64, dtype=torch.int32)
    elif fault == "k_zero":
        k = 0
    elif fault == "k_past_rows":
        k = 65
    elif fault == "l2_uint16":
        rows, metric = quantize_cdf(rows), "l2"
    before = (qk.KERNEL.launches, qk.DIST_KERNEL.launches)
    with pytest.raises(ValueError):
        qk.query_cuda(rows, pos, size, q, f, k, metric)
    assert (qk.KERNEL.launches, qk.DIST_KERNEL.launches) == before


def test_cpu_dispatch_is_the_plain_version():
    """``query`` runs ``query_plain`` on CPU tensors (and k = 0 gives
    empty answers there too); uint16 rows dequantise to the float32 rows'
    codes."""
    rows, pos, h, rng = _data("wasserstein", "uint16", seed=21)
    q = histogram_cdf(torch.from_numpy(h[:2].copy()), 1e-8)
    f = torch.zeros((2, 4))
    got = qk.query(rows, pos, N, q, f, K, "wasserstein")
    want = qk.query_plain(rows, pos, N, q, f, K, "wasserstein")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert qk.query(rows, pos, N, q, f, 0, "wasserstein")[0].shape == (2, 0)
    x = dequantize_rows(rows)
    assert x.dtype == torch.float32 and x.shape == rows.shape
