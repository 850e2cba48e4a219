"""Kernel M (``csrc/mine.cu``, ``training/mine_kernel.py``) and the
mining executable (``training/miner.py``) on the CPU: the plain version
against the JAX miner's "hard" strategy, a numpy model of the kernel's
frame split and merge against the plain version bit for bit, the r-th
positive draw, and the entry points' refusal of a card that is not there.

The kernel runs only on a card (``chip_smoke.py`` phase 7 holds it
against ``mine_plain`` there, bit for bit); the model holds its visiting
and merge order here, with its constants read from the CUDA source. Small
shapes: 150-600 frames, 40-bin histograms."""

import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

from neural_spectral_codec_tpu.data.synthetic import (  # noqa: E402
    loop_trajectory)
from neural_spectral_codec_tpu.training import miner as jminer  # noqa: E402
from neural_spectral_codec_torch.training import (  # noqa: E402
    mine_kernel, miner as tminer)

torch.set_num_threads(2)
PARAMS = np.array([5.0, 30, 10.0, 50.0, 30], np.float32)   # miner defaults
TPARAMS = tuple(float(v) for v in PARAMS)
CSRC = REPO / "neural_spectral_codec_torch" / "csrc"


def source_constants(name: str) -> dict:
    """The ``constexpr int kName = <literal>;`` lines of a CUDA source."""
    text = (CSRC / name).read_text()
    return {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}


M_SRC = source_constants("mine.cu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _data(n=150, seed=2, bins=40, distinct=None):
    """A two-lap loop (positives: the other lap), jittered off the
    thresholds; random histograms (untied W₁), or rows drawn from
    ``distinct`` histograms (every W₁ tied with many others)."""
    rng = np.random.default_rng(seed)
    poses = loop_trajectory(n, radius=60.0, loops=2.0)
    poses[:, :2, 3] += rng.normal(0, 0.7, (n, 2))
    desc = rng.random((n, bins)).astype(np.float32) ** 3
    if distinct:
        desc = desc[rng.integers(0, distinct, n)]
    positions = poses[:, :3, 3].astype(np.float32)
    cdfs = np.cumsum(desc / np.maximum(desc.sum(1, keepdims=True), 1e-12),
                     axis=1).astype(np.float32)
    return positions, cdfs, desc, poses


def _masks(positions, anchors=None):
    """The positive and negative masks in float32, as the kernel forms
    them: (dx² + dy²) + dz², each operation rounded, then sqrt."""
    n = len(positions)
    a = np.arange(n) if anchors is None else np.asarray(anchors)
    diff = (positions[a][:, None, :] - positions[None, :, :]).astype(
        np.float32)
    sq = diff * diff
    d = np.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])
    gap = np.abs(a[:, None] - np.arange(n)[None, :])
    fgap = gap.astype(np.float32)
    pos = (d < PARAMS[0]) & (fgap >= PARAMS[1]) & (gap > 0)
    neg = ((d >= PARAMS[2]) & (d <= PARAMS[3]) & (fgap >= PARAMS[4])
           & (gap > 0))
    return pos, neg


def _w1(acdf, cdfs):
    """W₁ summed bin by bin in increasing order in float32."""
    acc = np.zeros((len(acdf), len(cdfs)), np.float32)
    for b in range(acdf.shape[1]):
        acc = acc + np.abs(acdf[:, None, b] - cdfs[None, :, b])
    return acc


# ---------------- the plain version against JAX ----------------

@pytest.mark.parametrize("chunk,tile", [(64, 32), (64, 4096), (150, 32),
                                        (37, 16)])
def test_hard_mining_equals_jax(chunk, tile, monkeypatch):
    """The miner's "hard" path (``MiningExecutable`` on the CPU, kernel M's
    plain version) against JAX's ``_mine_kernel_chunked``: the hard
    negatives and ``valid`` identical on untied histograms (the bar of
    ``test_torch_training.test_mined_negatives_equal_jax``), anchors in
    chunks (the last one overlapping the one before, as JAX's revisit
    scan does), frames in tiles of ``tile``; positives inside JAX's
    positive mask."""
    monkeypatch.setattr(tminer, "TILE", tile)
    positions, cdfs, _, _ = _data()
    jp, jn, jv = jminer._mine_kernel_chunked(
        positions, cdfs, jax.random.key(0), PARAMS, "hard", chunk=chunk)
    tp, tn, tv = tminer._mine_kernel_chunked(
        _t(positions), _t(cdfs), torch.Generator().manual_seed(0), TPARAMS,
        "hard", chunk=chunk)
    pos, neg = _masks(positions)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tv, pos.any(1) & neg.any(1))
    assert tv.sum() > 50
    np.testing.assert_array_equal(tn, jn)
    rows = np.nonzero(tv)[0]
    assert pos[rows, tp[rows]].all() and pos[rows, jp[rows]].all()
    assert tp.dtype == np.int64 and tn.dtype == np.int64


def test_ties_go_to_the_lower_index_as_in_jax():
    """Histograms drawn from 4 distinct rows, so each anchor's least W₁
    is shared by many negatives: the port and JAX both take the lowest
    index."""
    positions, cdfs, _, _ = _data(n=300, seed=4, distinct=4)
    _, jn, jv = jminer._mine_kernel_chunked(
        positions, cdfs, jax.random.key(0), PARAMS, "hard", chunk=128)
    _, tn, tv = tminer._mine_kernel_chunked(
        _t(positions), _t(cdfs), torch.Generator().manual_seed(0), TPARAMS,
        "hard", chunk=128)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tn, jn)
    _, neg = _masks(positions)
    w = np.where(neg, _w1(cdfs, cdfs), np.inf)
    rows = np.nonzero(tv)[0]
    first = np.array([np.flatnonzero(w[r] == w[r].min())[0] for r in rows])
    np.testing.assert_array_equal(tn[rows], first)
    assert np.mean([(w[r] == w[r].min()).sum() > 1 for r in rows]) > 0.9


def test_counts_equal_the_masks():
    """``mine_plain``'s counts are the masks' row sums; ``valid`` is both
    counts positive."""
    positions, cdfs, _, _ = _data(seed=5)
    u = torch.rand(150, generator=torch.Generator().manual_seed(1))
    out = mine_kernel.mine_plain(_t(positions), _t(cdfs), 0, 150, TPARAMS, u,
                                 tile=64)
    pos, neg = _masks(positions)
    np.testing.assert_array_equal(out.count_pos.numpy(), pos.sum(1))
    np.testing.assert_array_equal(out.count_neg.numpy(), neg.sum(1))
    np.testing.assert_array_equal(out.valid.numpy(),
                                  (pos.sum(1) > 0) & (neg.sum(1) > 0))
    assert all(t.dtype == torch.int32 for t in out[:4])


# ---------------- a numpy model of the kernel's split ----------------

def _before(w, j, bw, bj):
    return w < bw or (w == bw and j < bj)


def mine_model(positions, cdfs, start, count, splits):
    """Kernel M's hard negatives as ``csrc/mine.cu`` finds them: anchor
    tiles of kBA, frames in tiles of kBJ cut into ``splits`` contiguous
    parts, each thread's rows ty·kPer .. ty·kPer + kPer − 1 of every tile
    visited in increasing order with a strict <, then the threads of an
    anchor merged by (W₁, index), then the splits. Returns (index, W₁)."""
    n = len(positions)
    ba, bj, per = M_SRC["kBA"], M_SRC["kBJ"], M_SRC["kPer"]
    groups = M_SRC["kThreads"] // (ba // per)     # row-threads of an anchor
    assert groups * per == bj
    anchors = np.arange(start, start + count)
    _, neg = _masks(positions, anchors)
    w1 = _w1(cdfs[anchors], cdfs)
    n_tiles = -(-n // bj)
    none = np.iinfo(np.int32).max
    idx, best = np.zeros(count, np.int64), np.full(count, np.inf, np.float32)
    for a in range(count):
        merged = (np.float32(np.inf), none)
        for s in range(splits):
            lo, hi = n_tiles * s // splits, n_tiles * (s + 1) // splits
            part = (np.float32(np.inf), none)
            for ty in range(groups):
                bw, bjx = np.float32(np.inf), none
                for t in range(lo, hi):
                    for jj in range(per):
                        j = t * bj + ty * per + jj
                        if j < n and neg[a, j] and w1[a, j] < bw:
                            bw, bjx = w1[a, j], j
                if _before(bw, bjx, *part):
                    part = (bw, bjx)
            if _before(*part, *merged):
                merged = part
        best[a] = merged[0]
        idx[a] = 0 if merged[1] == none else merged[1]
    return idx, best


def _split_case(case):
    if case == "untied":
        return _data(n=300, seed=6)[:2]
    if case == "ties":
        return _data(n=300, seed=7, distinct=3)[:2]
    # equal rows on both sides of every tile and split boundary
    positions, cdfs, _, _ = _data(n=300, seed=8)
    bj = M_SRC["kBJ"]
    for edge in range(bj, 300, bj):
        cdfs[edge] = cdfs[edge - 1]
    return positions, cdfs


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
@pytest.mark.parametrize("case", ["untied", "ties", "edges"])
def test_split_model_equals_plain(case, splits):
    """The model's hard negatives equal ``mine_plain``'s bit for bit (the
    index, and W₁ the least over the negatives) for every split count, on
    untied rows, on rows from 3 histograms (ties everywhere) and with
    equal rows across each tile and split boundary."""
    positions, cdfs = _split_case(case)
    start, count = 40, 200
    idx, best = mine_model(positions, cdfs, start, count, splits)
    u = torch.zeros(count)
    out = mine_kernel.mine_plain(_t(positions), _t(cdfs), start, count,
                                 TPARAMS, u, tile=64)
    np.testing.assert_array_equal(out.neg_idx.numpy(), idx)
    _, neg = _masks(positions, np.arange(start, start + count))
    w = np.where(neg, _w1(cdfs[start:start + count], cdfs), np.inf)
    np.testing.assert_array_equal(best, w.min(1).astype(np.float32))
    assert out.valid.numpy().sum() > 20


def test_row_splits_cover_the_frames():
    """``row_splits`` gives about two CTAs an SM, never more splits than
    frame tiles, and the splits' tile ranges cover every tile once."""
    for n, count in ((100_000, 2048), (20_000, 2048), (300, 64), (64, 1)):
        s = mine_kernel.row_splits(n, count, 132)
        tiles = -(-n // mine_kernel.ROWS_PER_TILE)
        assert 1 <= s <= tiles
        cover = [t for k in range(s) for t in range(tiles * k // s,
                                                    tiles * (k + 1) // s)]
        assert cover == list(range(tiles))
    assert mine_kernel.row_splits(100_000, 2048, 132) * 32 >= 2 * 132
    assert (mine_kernel.ANCHORS_PER_CTA, mine_kernel.ROWS_PER_TILE) == (
        M_SRC["kBA"], M_SRC["kBJ"])


# ---------------- the positive draw ----------------

def _draw(positions, cdfs, u, start=0):
    return mine_kernel.mine_plain(_t(positions), _t(cdfs), start, len(u),
                                  TPARAMS, _t(np.asarray(u, np.float32)))


def test_draw_ends_of_u():
    """u = 0 takes each anchor's first positive, u = the largest float
    below 1 its last one."""
    positions, cdfs, _, _ = _data(seed=9)
    pos, _ = _masks(positions)
    has = pos.any(1)
    lo = _draw(positions, cdfs, np.zeros(150)).pos_idx.numpy()
    hi = _draw(positions, cdfs, np.full(150, np.nextafter(
        np.float32(1), np.float32(0)))).pos_idx.numpy()
    assert has.sum() > 50
    np.testing.assert_array_equal(lo[has], pos[has].argmax(1))
    np.testing.assert_array_equal(
        hi[has], pos.shape[1] - 1 - pos[has][:, ::-1].argmax(1))
    assert (lo[~has] == 0).all() and (hi[~has] == 0).all()


def test_draw_rth_positive_and_invalid_anchors():
    """For random u, the r-th positive with r = min(⌊u · count⌋, count −
    1) in float32; anchors without a positive or a negative are invalid
    (a frame far from every other and the sequence's ends)."""
    positions, cdfs, _, _ = _data(seed=10)
    positions[75] = [1e4, 1e4, 0.0]                 # no positive, no negative
    pos, neg = _masks(positions)
    u = np.random.default_rng(3).random(150).astype(np.float32)
    out = _draw(positions, cdfs, u)
    cnt = pos.sum(1)
    r = np.minimum(np.floor(u * cnt.astype(np.float32)).astype(np.int64),
                   cnt - 1)
    for a in np.nonzero(cnt)[0]:
        assert out.pos_idx[a] == np.flatnonzero(pos[a])[r[a]]
    valid = out.valid.numpy()
    assert not valid[75] and not (valid & ~(cnt > 0)).any()
    np.testing.assert_array_equal(valid, (cnt > 0) & neg.any(1))


def test_draw_is_uniform_over_four_positives():
    """2,000 draws from one seeded generator for an anchor with exactly 4
    positives: each is taken 500 ± 97 times (5 standard deviations of
    Binomial(2000, 1/4), about 6e-7 of falling outside by chance)."""
    positions = np.zeros((40, 3), np.float32)
    positions[:, 0] = np.arange(40) * 20.0
    positions[[0, 31, 33, 35, 37], 0] = [0.0, 1.0, 2.0, 3.0, 4.0]
    cdfs = np.cumsum(np.full((40, 8), 0.125, np.float32), axis=1)
    pos, _ = _masks(positions, [0])
    assert pos.sum() == 4
    u = torch.rand(2000, generator=torch.Generator().manual_seed(11))
    picks = [int(_draw(positions, cdfs, u[i:i + 1]).pos_idx[0])
             for i in range(2000)]
    counts = {j: picks.count(j) for j in np.flatnonzero(pos[0])}
    assert sum(counts.values()) == 2000
    sd = math.sqrt(2000 * 0.25 * 0.75)
    assert all(abs(c - 500) <= 5 * sd for c in counts.values()), counts


# ---------------- the executable ----------------

def test_mining_executable_runs_the_step_on_the_cpu():
    """On the CPU the mining step runs eagerly (counted); one executable
    a (n, chunk): a sequence of 150 frames in chunks of 64 makes one; the
    draws come from the miner's generator (same seed, same triplets)."""
    tminer.clear_cache()
    before = dict(tminer.STATS)
    _, _, desc, poses = _data(seed=12)
    runs = [tminer.TripletMiner(seed=3, device="cpu").mine_triplets(
        desc, poses) for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].dtype == np.int64 and runs[0].shape[1] == 3
    assert len(tminer.cached_executables()) == 1
    assert tminer.STATS["eager_steps"] - before["eager_steps"] == 2 * 1
    assert tminer.STATS["captures"] == before["captures"]
    tminer.clear_cache()


def test_other_strategies_stay_op_by_op():
    """"semi-hard" and "random" run the op-by-op chunk (no executable)."""
    tminer.clear_cache()
    _, _, desc, poses = _data(seed=13)
    for strategy in ("semi-hard", "random"):
        out = tminer.TripletMiner(mining_strategy=strategy,
                                  device="cpu").mine_triplets(desc, poses)
        assert len(out) > 50
    assert tminer.cached_executables() == []


# ---------------- no card ----------------

def _no_card(fn):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, ValueError, AssertionError)):
        fn()


@pytest.mark.parametrize("entry", ["miner", "executable", "mine_cuda",
                                   "mine_cuda_cpu_tensors"])
def test_cuda_without_a_card_raises(entry):
    """Every new entry point asked for ``cuda`` without a card raises."""
    positions, cdfs, _, _ = _data(n=60, seed=14)
    p, c = _t(positions), _t(cdfs)
    calls = {
        "miner": lambda: tminer.TripletMiner(device="cuda"),
        "executable": lambda: tminer.MiningExecutable(
            60, 60, 40, TPARAMS, torch.device("cuda")),
        "mine_cuda": lambda: mine_kernel.mine(
            p.to("cuda"), c, torch.zeros(1, dtype=torch.int32), 60, TPARAMS,
            torch.zeros(60)),
        "mine_cuda_cpu_tensors": lambda: mine_kernel.mine_cuda(
            p, c, torch.zeros(1, dtype=torch.int32), 60, TPARAMS,
            torch.zeros(60)),
    }
    _no_card(calls[entry])
