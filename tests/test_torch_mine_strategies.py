"""The miner's "semi-hard" and "random" strategies through their mining
executables (``training/miner.py``) on the CPU, against the JAX miner's
``_mine_kernel_chunked``, and the plain versions of kernel M's three other
entries (``training/mine_kernel.py``: ``counts_plain``, ``rows_plain``,
``draw_plain``) against their definitions, with a numpy model of the
kernel's split-first draw over either mask.

Bars: negatives, ``valid`` and counts bit-equal (the port sums W₁ bin by
bin in float32; JAX sums in XLA's order, which moves no ranking on untied
histograms, and on tied ones the tied sums are bit-identical rows, so no
order can reorder them); draws inside JAX's masks (its categorical draws
cannot be reproduced). Small shapes: 150-600 frames, 40-bin histograms.
The kernels run only on a card (``chip_smoke.py`` phase 7k holds them
bit for bit against these plain versions)."""

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
from neural_spectral_codec_torch.evaluation import (  # noqa: E402
    RankExecutable)
from neural_spectral_codec_torch.training import (  # noqa: E402
    mine_kernel as mk, miner as tminer, select_kernel as sk)

torch.set_num_threads(2)
PARAMS = np.array([5.0, 30, 10.0, 50.0, 30], np.float32)   # miner defaults
TPARAMS = tuple(float(v) for v in PARAMS)
BELOW_ONE = float(np.nextafter(np.float32(1), np.float32(0)))


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


def _mine(strategy, positions, cdfs, seed, chunk, tile=None, monkeypatch=None):
    if tile is not None:
        monkeypatch.setattr(tminer, "TILE", tile)
    return tminer._mine_kernel_chunked(
        _t(positions), _t(cdfs), torch.Generator().manual_seed(seed),
        TPARAMS, strategy, chunk=chunk)


# ---------------- the strategies against JAX ----------------

@pytest.mark.parametrize("chunk,tile", [(64, 32), (37, 4096)])
def test_semi_hard_equals_jax(chunk, tile, monkeypatch):
    """"Semi-hard" through its executable: the negatives (the median
    negative, place count // 2 of the stable order) and ``valid`` equal
    JAX's on untied histograms, anchors in chunks of 64 and 37 (the last
    moved back), frames in tiles of ``tile``; positives inside JAX's
    mask."""
    positions, cdfs, _, _ = _data()
    jp, jn, jv = jminer._mine_kernel_chunked(
        positions, cdfs, jax.random.key(0), PARAMS, "semi-hard", chunk=chunk)
    tp, tn, tv = _mine("semi-hard", positions, cdfs, 0, chunk, tile,
                       monkeypatch)
    pos, neg = _masks(positions)
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 50
    np.testing.assert_array_equal(tn, jn)
    rows = np.nonzero(tv)[0]
    assert pos[rows, tp[rows]].all() and neg[rows, tn[rows]].all()
    assert tp.dtype == np.int64 and tn.dtype == np.int64


def test_semi_hard_ties_take_the_stable_median():
    """Histograms drawn from 4 distinct rows, so every W₁ is tied with
    many others: the negative is numpy's stable argsort of the in-order
    W₁ (+inf outside the negatives) at place count // 2, and JAX's. The
    tied sums are bit-identical (equal rows summed in one order), so no
    sum order, JAX's included, can reorder them."""
    positions, cdfs, _, _ = _data(n=300, seed=4, distinct=4)
    _, jn, jv = jminer._mine_kernel_chunked(
        positions, cdfs, jax.random.key(0), PARAMS, "semi-hard", chunk=128)
    _, tn, tv = _mine("semi-hard", positions, cdfs, 0, 128)
    _, neg = _masks(positions)
    w = np.where(neg, _w1(cdfs, cdfs), np.inf)
    order = np.argsort(w, axis=1, kind="stable")
    want = order[np.arange(len(w)), neg.sum(1) // 2]
    np.testing.assert_array_equal(tn, want)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tv, jv)
    rows = np.nonzero(tv)[0]
    assert np.mean([(w[r] == w[r, tn[r]]).sum() > 1 for r in rows]) > 0.9


def test_random_strategy_equals_jax_masks():
    """"Random" through its executable: ``valid`` equals JAX's, every
    positive and negative falls inside JAX's masks, the same seed gives
    the same triplets and the draws are not one index."""
    positions, cdfs, _, _ = _data(seed=3)
    _, _, jv = jminer._mine_kernel_chunked(
        positions, cdfs, jax.random.key(1), PARAMS, "random", chunk=64)
    runs = [_mine("random", positions, cdfs, 1, 64) for _ in range(2)]
    tp, tn, tv = runs[0]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    pos, neg = _masks(positions)
    np.testing.assert_array_equal(tv, jv)
    rows = np.nonzero(tv)[0]
    assert len(rows) > 50
    assert pos[rows, tp[rows]].all() and neg[rows, tn[rows]].all()
    assert len(np.unique(tn[rows])) > 5 and len(np.unique(tp[rows])) > 5
    other = _mine("random", positions, cdfs, 2, 64)
    assert not np.array_equal(other[1], tn)       # another seed, other draws


def test_random_draws_cover_the_negatives():
    """2,000 seeded draws for one anchor with 8 negatives: each is taken
    250 ± 5 standard deviations of Binomial(2000, 1/8) times."""
    positions = np.zeros((40, 3), np.float32)
    positions[:, 0] = np.arange(40) * 60.0                # all too far
    positions[[31, 32, 33, 34, 35, 36, 37, 38], 0] = np.arange(8) + 20.0
    pos, neg = _masks(positions, [0])
    assert neg.sum() == 8
    u = torch.rand(2000, generator=torch.Generator().manual_seed(5))
    cnt = torch.full((1,), 8, dtype=torch.int32)
    picks = [int(mk.draw_plain(_t(positions), 0, 1, TPARAMS, u[i:i + 1], cnt,
                               "neg")[0]) for i in range(2000)]
    counts = {j: picks.count(j) for j in np.flatnonzero(neg[0])}
    assert sum(counts.values()) == 2000
    sd = np.sqrt(2000 * 0.125 * 0.875)
    assert all(abs(c - 250) <= 5 * sd for c in counts.values()), counts


# ---------------- the plain versions against their definitions ----------

@pytest.mark.parametrize("start,count,tile", [(0, 150, 64), (40, 37, 16),
                                              (149, 1, 4096)])
def test_counts_and_rows_plain_equal_their_definitions(start, count, tile):
    """``counts_plain``: the masks' row sums and both positive;
    ``rows_plain``: the in-order float32 W₁ where the frame is a negative
    of the anchor and +inf elsewhere, bit for bit, with the same counts;
    written into ``out`` when given; the hard negative of ``mine_plain``
    is the block's first least entry."""
    positions, cdfs, _, _ = _data(seed=5)
    anchors = np.arange(start, start + count)
    pos, neg = _masks(positions, anchors)
    got = mk.counts_plain(_t(positions), start, count, TPARAMS, tile)
    np.testing.assert_array_equal(got.count_pos.numpy(), pos.sum(1))
    np.testing.assert_array_equal(got.count_neg.numpy(), neg.sum(1))
    np.testing.assert_array_equal(got.valid.numpy(),
                                  pos.any(1) & neg.any(1))
    assert got.count_pos.dtype == torch.int32
    out = torch.full((count, len(positions)), -1.0)
    block, rows = mk.rows_plain(_t(positions), _t(cdfs), start, count,
                                TPARAMS, out, tile)
    want = np.where(neg, _w1(cdfs[anchors], cdfs), np.float32(np.inf))
    assert block is out
    np.testing.assert_array_equal(block.numpy().view(np.int32),
                                  want.view(np.int32))
    for a, b in zip(rows, got):
        assert torch.equal(a, b)
    hard = mk.mine_plain(_t(positions), _t(cdfs), start, count, TPARAMS,
                         torch.zeros(count), tile)
    first = np.where(neg.any(1), want.argmin(1), 0)
    np.testing.assert_array_equal(hard.neg_idx.numpy(), first)


@pytest.mark.parametrize("which", ["pos", "neg"])
def test_draw_plain_takes_the_rth_member(which):
    """``draw_plain``: the r-th member in index order of the mask, r =
    min(⌊u · count⌋, count − 1) in float32, for u = 0, u just under 1 and
    random u; 0 for an anchor whose count is 0; the positive draw equals
    ``mine_plain``'s."""
    positions, cdfs, _, _ = _data(seed=10)
    positions[75] = [1e4, 1e4, 0.0]                 # no positive, no negative
    pos, neg = _masks(positions)
    m = pos if which == "pos" else neg
    cnt = m.sum(1)
    rng = np.random.default_rng(3)
    for u in (np.zeros(150), np.full(150, BELOW_ONE), rng.random(150)):
        u = u.astype(np.float32)
        got = mk.draw_plain(_t(positions), 0, 150, TPARAMS, _t(u),
                            _t(cnt.astype(np.int32)), which, tile=64)
        r = np.minimum(np.floor(u * cnt.astype(np.float32)).astype(np.int64),
                       cnt - 1)
        want = np.array([np.flatnonzero(m[a])[r[a]] if cnt[a] else 0
                         for a in range(150)])
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32 and got[75] == 0 and cnt[75] == 0
        if which == "pos":
            hard = mk.mine_plain(_t(positions), _t(cdfs), 0, 150, TPARAMS,
                                 _t(u), tile=64)
            assert torch.equal(hard.pos_idx, got)
    assert (cnt > 0).sum() > 100


def draw_model(positions, start, count, splits, u, which):
    """Kernel M's mask draw as ``csrc/mine.cu`` makes it: the mask's
    members counted split by split (the partials of the entry before it),
    the split that holds the r-th member found from those counts in split
    order, then that split's frames walked; 0 without a member."""
    anchors = np.arange(start, start + count)
    m = _masks(positions, anchors)[which == "neg"]
    bounds = mk.split_frames(len(positions), splits)
    out = np.zeros(count, np.int64)
    for a in range(count):
        counts = [int(m[a, lo:hi].sum()) for lo, hi in bounds]
        cnt = sum(counts)
        if cnt == 0:
            continue
        r = min(int(np.floor(np.float32(u[a]) * np.float32(cnt))), cnt - 1)
        seen = 0
        for (lo, hi), c in zip(bounds, counts):
            if seen + c > r:
                out[a] = lo + np.flatnonzero(m[a, lo:hi])[r - seen]
                break
            seen += c
    return out


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("which", ["pos", "neg"])
def test_split_draw_model_equals_plain(splits, which):
    """The split-first walk over either mask gives ``draw_plain``'s member
    at 1, 2 and 5 splits of 600 frames, u random and at 0 and just under
    1; the negatives spread over several splits."""
    positions, _, _, _ = _data(n=600, seed=21)
    start, count = 60, 420
    u = np.random.default_rng(22).random(count).astype(np.float32)
    u[:20], u[20:40] = 0.0, BELOW_ONE
    m = _masks(positions, np.arange(start, start + count))[which == "neg"]
    want = mk.draw_plain(_t(positions), start, count, TPARAMS, _t(u),
                         _t(m.sum(1).astype(np.int32)), which, tile=64)
    np.testing.assert_array_equal(
        draw_model(positions, start, count, splits, u, which), want.numpy())
    if which == "neg" and splits > 1:
        per = [[m[a, lo:hi].sum() for lo, hi in
                mk.split_frames(600, splits)] for a in range(count)]
        assert any(sum(c > 0 for c in row) > 1 for row in per)


def test_semi_hard_step_is_rows_then_select():
    """The "semi-hard" step's negative is kernel S's plain version on the
    W₁ block at count_neg // 2, and the block is the executable's arena
    section (one address for every chunk)."""
    positions, cdfs, _, _ = _data(seed=6)
    exe = tminer.MiningExecutable(150, 64, cdfs.shape[1], TPARAMS,
                                  torch.device("cpu"), strategy="semi-hard")
    exe.load_sequence(_t(positions), _t(cdfs))
    w1 = exe.data.dev["w1"]
    ptr = w1.data_ptr()
    for start in (0, 86):
        u = torch.rand((1, 64), generator=torch.Generator().manual_seed(7))
        out, captured = exe.run({"start": np.array([start], np.int32),
                                 "u": u})
        assert not captured and w1.data_ptr() == ptr
        block, counts = mk.rows_plain(_t(positions), _t(cdfs), start, 64,
                                      TPARAMS)
        assert torch.equal(block, w1)
        want = sk.select_plain(block, counts.count_neg // 2)
        np.testing.assert_array_equal(out["neg_idx"], want.numpy())
        np.testing.assert_array_equal(out["count_neg"],
                                      counts.count_neg.numpy())


# ---------------- no card ----------------

def _no_card(fn):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, ValueError, AssertionError)):
        fn()


@pytest.mark.parametrize("entry", [
    "counts_cuda", "rows_cuda", "draw_cuda", "mine_counts", "mine_rows",
    "mine_draw", "semi_hard_executable", "random_executable", "miner",
    "select_cuda", "select", "rank_executable", "evaluate"])
def test_cuda_without_a_card_raises(entry):
    """Every new entry point asked for ``cuda`` without a card raises
    (CPU tensors given to a ``*_cuda`` entry raise too)."""
    positions, cdfs, _, poses = _data(n=60, seed=14)
    p, c = _t(positions), _t(cdfs)
    st = torch.zeros(1, dtype=torch.int32)
    cnt = torch.zeros(60, dtype=torch.int32)
    cuda = torch.device("cuda")
    calls = {
        "counts_cuda": lambda: mk.counts_cuda(p, st, 60, TPARAMS),
        "rows_cuda": lambda: mk.rows_cuda(p, c, st, 60, TPARAMS,
                                          torch.empty(60, 60)),
        "draw_cuda": lambda: mk.draw_cuda(p, st, 60, TPARAMS,
                                          torch.zeros(60), cnt, "neg", (
            torch.zeros((1, 60, 4), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32)), mk.tile_boxes(p)),
        "mine_counts": lambda: mk.mine_counts(p.to("cuda"), st, 60, TPARAMS),
        "mine_rows": lambda: mk.mine_rows(p.to("cuda"), c, st, 60, TPARAMS,
                                          torch.empty(60, 60)),
        "mine_draw": lambda: mk.mine_draw(p.to("cuda"), st, 60, TPARAMS,
                                          torch.zeros(60), cnt, "pos",
                                          mk.tile_boxes(p)),
        "semi_hard_executable": lambda: tminer.MiningExecutable(
            60, 60, 40, TPARAMS, cuda, strategy="semi-hard"),
        "random_executable": lambda: tminer.mining_executable(
            60, 60, 40, TPARAMS, cuda, strategy="random"),
        "miner": lambda: tminer.TripletMiner(mining_strategy="semi-hard",
                                             device="cuda"),
        "select_cuda": lambda: sk.select_cuda(torch.zeros(4, 8),
                                              torch.zeros(4,
                                                          dtype=torch.int32)),
        "select": lambda: sk.select(torch.zeros(4, 8, device="cuda"),
                                    torch.zeros(4, dtype=torch.int32)),
        "rank_executable": lambda: RankExecutable(60, 16, 8, 10, 30, cuda),
        "evaluate": lambda: __import__(
            "neural_spectral_codec_torch.evaluation",
            fromlist=["x"]).evaluate_place_recognition(
                np.zeros((60, 16), np.float32), poses, device="cuda"),
    }
    _no_card(calls[entry])
