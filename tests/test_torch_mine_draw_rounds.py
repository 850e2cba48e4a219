"""Kernel M's draw (``draw_member`` behind ``nsc_mine_draw`` and
``nsc_mine_draw_mask`` in ``csrc/mine.cu``) as a numpy model of its
design, against ``mine_kernel.draw_plain`` and JAX's masks, on the CPU.

The model follows the kernel step by step: one CTA an anchor; the split
that holds the r-th member found from the per-split counts by a warp's
prefix sum over 32 splits at a time; then, in passes of kDrawGate tiles
of that split (one a thread), the 128-frame tiles whose box can hold a
member of the drawn mask (the box bounds of the counts entry's
``skip_block`` with the anchor for the anchors' box), listed in index
order; the list walked in rounds of kDrawWarps tiles (one a warp, 4
frames a lane), each warp's members counted by ballots, one prefix over
the warps' counts a round, and the member found by the owning warp's
ballot and population count. Its mask is ``mask_bounds``' test on the
rounded sum of squares and the integer gap (no square root). The plain
version walks the sqrt masks in index order: the two must give the same
frame for every anchor, over both masks, bit for bit; no tile the gate
skips holds a member; ``mine_kernel.draw_gate`` and ``draw_rounds`` are
the model's gate and rounds. The inputs also go through JAX's
``_mine_chunk`` on the CPU ("random", its masks read from the logits it
hands ``jax.random.categorical``): every drawn frame lies in JAX's mask.

Cases: a city of ten laps at 1, 3 and 16 splits (u = 0, u just under 1
and random u; an anchor moved far away has no member; a NaN anchor and a
NaN frame); ``chip_smoke._bound_positions``, whose pairs sit at each of
``mask_bounds``' squared bounds and one ulp either side (u aimed at the
members on the bounds); an anchor whose member is the last frame of its
split; a split of more tiles than one gate pass. Seeded numpy only,
small shapes, no timing. The kernel itself runs only on a card
(``chip_smoke.py`` phase 7k holds it against ``draw_plain`` there, bit
for bit)."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

import chip_smoke  # noqa: E402
from neural_spectral_codec_tpu.training import miner as jminer  # noqa: E402
from neural_spectral_codec_torch.training import (  # noqa: E402
    mine_kernel as mk)

torch.set_num_threads(2)
SRC = (REPO / "neural_spectral_codec_torch" / "csrc" / "mine.cu").read_text()
M_SRC = {m[1]: int(m[2]) for m in re.finditer(
    r"constexpr int (k\w+) = (\d+);", SRC)}
WARPS = M_SRC["kDrawWarps"]
LANES_FRAMES = M_SRC["kDrawUnroll"]
TILE = 32 * LANES_FRAMES                    # kDrawTile, one frame tile
GATE = 32 * WARPS                           # kDrawGate
SCALE = (5.0, 30.0, 10.0, 100.0, 30.0)      # scale_100k's thresholds
DEFAULT = (5.0, 30.0, 10.0, 50.0, 30.0)     # the miner's defaults
F32 = np.float32
BELOW_ONE = float(np.nextafter(F32(1), F32(0)))


def members(positions: np.ndarray, anchors: np.ndarray, params,
            which: str) -> np.ndarray:
    """(anchors, n) the kernel's mask test: s = (dx·dx + dy·dy) + dz·dz,
    each operation rounded to float32, against ``mask_bounds``' squared
    bounds, and the integer gap against its integer ones."""
    b = mk.mask_bounds(tuple(float(v) for v in params))
    d = positions[anchors][:, None, :] - positions[None, :, :]
    sq = d * d
    gap = np.abs(anchors[:, None] - np.arange(len(positions))[None, :])
    with np.errstate(invalid="ignore"):
        s = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        if which == "pos":
            return (s < F32(b.pos_s)) & (gap >= b.pos_gap)
        return ((s >= F32(b.neg_lo_s)) & (s <= F32(b.neg_hi_s))
                & (gap >= b.neg_gap))


def boxes_np(positions: np.ndarray) -> np.ndarray:
    """(tiles, 6) each TILE-frame tile's min and max a column (NaN where
    the tile holds a NaN)."""
    return np.array([np.concatenate([positions[t:t + TILE].min(0),
                                     positions[t:t + TILE].max(0)])
                     for t in range(0, len(positions), TILE)], np.float32)


def gate_np(pa: np.ndarray, boxes: np.ndarray, params,
            which: str) -> np.ndarray:
    """(tiles,) whether the kernel's ``skip_tile`` keeps each tile (its
    box a row of ``boxes``) for an anchor at pa: per coordinate dlo = pa −
    max, dhi = pa − min (rounded), the least |d| (dlo where > 0, −dhi
    where dhi < 0, else 0, NaN where either is NaN) and the greatest
    (fmaxf: a NaN argument gives the other), squared and summed as the
    pair test sums them."""
    b = mk.mask_bounds(tuple(float(v) for v in params))
    with np.errstate(invalid="ignore", over="ignore"):
        dlo, dhi = pa - boxes[:, 3:], pa - boxes[:, :3]
        nan = np.isnan(dlo) | np.isnan(dhi)
        low = np.where(dlo > 0, dlo, np.where(
            dhi < 0, -dhi, np.where(nan, np.nan, 0))).astype(np.float32)
        high = np.fmax(np.abs(dlo), np.abs(dhi))
        s_lo = (low[:, 0] * low[:, 0] + low[:, 1] * low[:, 1]) \
            + low[:, 2] * low[:, 2]
        s_hi = (high[:, 0] * high[:, 0] + high[:, 1] * high[:, 1]) \
            + high[:, 2] * high[:, 2]
        if which == "pos":
            return ~(s_lo >= F32(b.pos_s))
        return ~((s_hi < F32(b.neg_lo_s)) | (s_lo > F32(b.neg_hi_s)))


def draw_rounds_model(positions: np.ndarray, start: int, count: int,
                      splits: int, u: np.ndarray, params,
                      which: str) -> tuple:
    """The kernel's draw, anchor by anchor: (the drawn frames, the rounds
    each took (0 without a member), the gate's (count, tiles) keep)."""
    n = len(positions)
    anchors = np.arange(start, start + count)
    mask = members(positions, anchors, params, which)
    bounds = mk.split_frames(n, splits)
    boxes = boxes_np(positions)
    keep = np.array([gate_np(positions[a], boxes, params, which)
                     for a in anchors])
    idx = np.zeros(count, np.int64)
    rounds = np.zeros(count, np.int64)
    lane = np.arange(32)
    for a in range(count):
        # the partials: the mask's members a split
        part = np.array([mask[a, lo:hi].sum() for lo, hi in bounds])
        cnt = int(part.sum())
        if cnt == 0:
            continue
        r = min(int(np.floor(F32(u[a]) * F32(cnt))), cnt - 1)
        # the split search, 32 splits a step with a warp's prefix sum
        split, seen = -1, 0
        for s0 in range(0, splits, 32):
            c = np.zeros(32, np.int64)
            c[:min(32, splits - s0)] = part[s0:s0 + 32]
            incl = np.cumsum(c)
            past = np.flatnonzero(seen + incl > r)
            if len(past):
                split = s0 + past[0]
                seen += int(incl[past[0]] - c[past[0]])
                break
            seen += int(incl[-1])
        assert split >= 0
        rr = r - seen
        lo, hi = bounds[split]
        t_lo, t_hi = lo // TILE, -(-hi // TILE)
        before = 0
        for g0 in range(t_lo, t_hi, GATE):
            kept = [t for t in range(g0, min(g0 + GATE, t_hi))
                    if keep[a, t]]
            for k0 in range(0, len(kept), WARPS):
                rounds[a] += 1
                # frame j of lane l, step q of warp w: its tile's first
                # + 32q + l; warps past the list start at hi
                first = np.array([kept[k0 + w] * TILE if k0 + w < len(kept)
                                  else hi for w in range(WARPS)])
                j = (first[:, None, None]
                     + 32 * np.arange(LANES_FRAMES)[None, :, None]
                     + lane[None, None, :])
                inside = (j < hi) & mask[a, np.minimum(j, n - 1)]
                c_warp = inside.sum(axis=(1, 2))      # popc of the ballots
                total = int(c_warp.sum())
                if before + total > rr:
                    break
                before += total
            else:
                continue
            break
        earlier = np.concatenate([[0], np.cumsum(c_warp)[:-1]])
        owner = [w for w in range(WARPS)
                 if before + earlier[w] <= rr < before + earlier[w]
                 + c_warp[w]]
        assert len(owner) == 1
        w = owner[0]
        f = before + int(earlier[w])
        for q in range(LANES_FRAMES):
            cq = int(inside[w, q].sum())
            if f + cq > rr:
                below = np.cumsum(inside[w, q]) - inside[w, q]
                hit = np.flatnonzero(inside[w, q] & (below == rr - f))
                assert len(hit) == 1
                idx[a] = j[w, q, hit[0]]
                break
            f += cq
    return idx, rounds, keep


def jax_masks(positions: np.ndarray, start: int, count: int, params):
    """JAX's positive and negative masks of ``_mine_chunk`` ("random") on
    the CPU: the supports of the logits it hands
    ``jax.random.categorical`` (run without jit, so that they are
    arrays)."""
    seen = []
    categorical = jax.random.categorical

    def spy(key, logits, *args, **kw):
        seen.append(np.asarray(logits) == 0)
        return categorical(key, logits, *args, **kw)

    cdfs = np.zeros((len(positions), 2), np.float32)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jax.random, "categorical", spy)
        jminer._mine_chunk(positions, cdfs, jax.random.key(0),
                           np.asarray(params, np.float32), np.int32(start),
                           count, "random")
    assert len(seen) == 2
    return {"pos": seen[0], "neg": seen[1]}


def city(n: int = 20_000, period: int = 2000, seed: int = 3) -> np.ndarray:
    """Ten laps of a 300 m circle, ~0.5 m of noise (the positions of
    ``scale_100k.synthetic_city``)."""
    rng = np.random.default_rng(seed)
    theta = 2 * np.pi * (np.arange(n) % period) / period
    return np.stack([300 * np.cos(theta) + 0.5 * rng.standard_normal(n),
                     300 * np.sin(theta) + 0.5 * rng.standard_normal(n),
                     np.zeros(n)], axis=1).astype(np.float32)


def edge_u(count: int, seed: int) -> np.ndarray:
    """u = 0 for the first quarter of the anchors, just under 1 for the
    second, seeded uniform for the rest."""
    u = np.random.default_rng(seed).random(count).astype(np.float32)
    u[:count // 4] = 0.0
    u[count // 4:count // 2] = BELOW_ONE
    return u


def aimed_u(mask: np.ndarray, targets: list) -> np.ndarray:
    """u per anchor whose draw is the member ``targets[a]`` (a frame of
    anchor a's mask): r = its rank, u = (r + ½) / count in float32."""
    u = np.zeros(len(mask), np.float32)
    for a, j in enumerate(targets):
        cnt = int(mask[a].sum())
        r = int(mask[a, :j].sum())
        u[a] = F32((r + 0.5) / cnt)
        assert int(np.floor(u[a] * F32(cnt))) == r
    return u


def check(positions, start, count, splits, u, params, which) -> dict:
    """The model equals ``draw_plain`` (and ``draw_rounds``' walk) and
    every drawn frame lies in JAX's mask and in the model's; returns the
    model's draws, rounds and masks."""
    idx, rounds, keep = draw_rounds_model(positions, start, count,
                                          splits, u, params, which)
    anchors = np.arange(start, start + count)
    mask = members(positions, anchors, params, which)
    # the gate is sound, and is mine_kernel's
    tiles = np.repeat(keep, TILE, axis=1)[:, :len(positions)]
    assert not (mask & ~tiles).any()
    np.testing.assert_array_equal(mk.draw_gate(
        torch.from_numpy(positions), start, count,
        mk.mask_bounds(tuple(float(v) for v in params)), which).numpy(),
        keep)
    cnt = mask.sum(1).astype(np.int32)
    want = mk.draw_plain(torch.from_numpy(positions), start, count,
                         tuple(float(v) for v in params),
                         torch.from_numpy(u), torch.from_numpy(cnt), which,
                         tile=1000)
    np.testing.assert_array_equal(idx, want.numpy())
    has = cnt > 0
    jmask = jax_masks(positions, start, count, params)[which]
    np.testing.assert_array_equal(jmask.sum(1), cnt)
    assert jmask[has, idx[has]].all() and mask[has, idx[has]].all()
    assert (idx[~has] == 0).all() and (rounds[~has] == 0).all()
    walk = mk.draw_rounds(torch.from_numpy(positions), start,
                          torch.from_numpy(idx), torch.from_numpy(cnt),
                          params, which, splits)
    assert walk["model_rounds_max"] == rounds.max()
    if has.any():
        assert walk["model_rounds_mean"] == pytest.approx(rounds[has].mean())
    # the gated work: per anchor the frames from its split's first to the
    # member, those in kept tiles, and the tiles they span
    n = len(positions)
    lo = np.array([a for a, _ in mk.split_frames(n, splits)])
    first = lo[np.searchsorted(lo, idx, side="right") - 1]
    frames, spanned = np.zeros(n, bool), np.zeros(len(keep[0]), bool)
    needed = tested = 0
    for a in np.flatnonzero(has):
        kept = tiles[a, first[a]:idx[a] + 1]
        needed += int(kept.sum())
        frames[first[a]:idx[a] + 1] |= kept
        frames[start + a] = True
        tested += idx[a] // TILE - first[a] // TILE + 1
        spanned[first[a] // TILE:idx[a] // TILE + 1] = True
    assert walk["model_frames_needed"] == needed
    assert walk["model_frames_touched"] == frames.sum()
    assert walk["model_tiles_tested"] == tested
    assert walk["model_tiles_touched"] == spanned.sum()
    return {"idx": idx, "rounds": rounds, "mask": mask, "count": cnt,
            "keep": keep}


@pytest.mark.parametrize("splits", [1, 3, 16])
@pytest.mark.parametrize("which", ["pos", "neg"])
def test_rounds_model_equals_plain_on_a_city(splits, which):
    """On ten laps of 2,000 frames: 96 anchors across a lap boundary, u
    at 0, just under 1 and random; anchor 7 moved far away (no member),
    anchor 9 and frame 12,345 NaN. The rounds reach past one where a
    split is longer than a round."""
    positions = city()
    start, count = 5_950, 96
    positions[start + 7] = [1e4, 1e4, 0.0]
    positions[start + 9, 1] = np.nan
    positions[12_345, 0] = np.nan
    u = edge_u(count, seed=splits)
    got = check(positions, start, count, splits, u, SCALE, which)
    assert got["count"][7] == 0 and got["count"][9] == 0
    assert (got["count"] > 0).sum() >= count - 2
    assert not got["mask"][:, 12_345].any()
    # the gate reads a part of the tiles here
    assert got["keep"].mean() < 0.5


@pytest.mark.parametrize("which", ["pos", "neg"])
def test_split_of_more_tiles_than_a_gate_pass(which):
    """One split of 313 tiles (more than a pass of kDrawGate): anchors
    whose member lies in the first pass and in the second (u = 0 and just
    under 1), the rounds counted on from the first pass."""
    positions = city(n=40_000, seed=5)
    start, count = 20_000, 16
    assert -(-len(positions) // TILE) > GATE
    u = np.where(np.arange(count) % 2 == 0, 0.0, BELOW_ONE).astype(
        np.float32)
    got = check(positions, start, count, 1, u, SCALE, which)
    late = got["idx"][1::2]
    assert (late >= GATE * TILE).all() and (got["idx"][::2] < GATE * TILE
                                            ).all()
    assert got["rounds"][1::2].min() > got["rounds"][::2].max()


@pytest.mark.parametrize("params", [SCALE, DEFAULT],
                         ids=["scale", "default"])
@pytest.mark.parametrize("splits", [1, 3, 16])
@pytest.mark.parametrize("which", ["pos", "neg"])
def test_rounds_model_equals_plain_at_the_bounds(params, splits, which):
    """``chip_smoke._bound_positions``: 128 anchors at the origin, then
    128-frame tiles whose pairs sit at each squared bound and one ulp
    either side, and at distances within ±3 ulps of each threshold; a
    NaN frame. u aims each anchor at a member whose sum of squares lies
    within an ulp of a bound of the drawn mask (in turn), so the draws
    land on the bounds; the members there are the sqrt masks'."""
    positions = chip_smoke._bound_positions(
        tuple(float(v) for v in np.array(params, np.float32)))
    count = 128
    anchors = np.arange(count)
    mask = members(positions, anchors, params, which)
    b = mk.mask_bounds(tuple(float(v) for v in params))
    d = positions[0] - positions
    sq = d * d
    with np.errstate(invalid="ignore"):
        s = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
    edges = [b.pos_s] if which == "pos" else [b.neg_lo_s, b.neg_hi_s]
    near = np.zeros(len(positions), bool)
    for e in edges:
        for v in (np.nextafter(F32(e), F32(0)), F32(e),
                  np.nextafter(F32(e), F32(np.inf))):
            near |= s == v
    on = [np.flatnonzero(near & mask[a]) for a in anchors]
    assert all(len(f) for f in on)
    u = aimed_u(mask, [f[a % len(f)] for a, f in enumerate(on)])
    got = check(positions, 0, count, splits, u, params, which)
    assert near[got["idx"]].all()
    # exactly at a bound: in the negatives, not in the positives
    exact = np.isin(s, [F32(e) for e in edges])
    assert mask[:, exact].any() == (which == "neg")


@pytest.mark.parametrize("splits", [1, 3, 16])
@pytest.mark.parametrize("which", ["pos", "neg"])
def test_member_at_the_last_frame_of_its_split(splits, which):
    """Anchors whose drawn member is the last frame of a split (the
    split's last round, its last warp's last lane when the split fills
    whole rounds) and of the sequence."""
    positions = city(n=6_000, period=1_500, seed=4)
    start, count = 2_000, 8
    ends = [hi - 1 for _, hi in mk.split_frames(len(positions), splits)]
    targets = [ends[a % len(ends)] for a in range(count)]
    targets[-1] = len(positions) - 1
    # the anchors 1 cm apart, every target frame at one offset from them
    base = positions[start].copy()
    positions[start:start + count] = base + np.outer(
        np.arange(count) * 0.01, [1.0, 0.0, 0.0]).astype(np.float32)
    offset = np.array([1.0, 0.5, 0.0] if which == "pos"
                      else [30.0, 0.0, 0.0], np.float32)
    positions[targets] = base + offset
    anchors = np.arange(start, start + count)
    mask = members(positions, anchors, SCALE, which)
    assert all(mask[a, j] for a, j in enumerate(targets))
    u = aimed_u(mask, targets)
    got = check(positions, start, count, splits, u, SCALE, which)
    np.testing.assert_array_equal(got["idx"], targets)


def test_draw_design_is_the_source():
    """The kernel's draw is the one modelled above (read from
    ``csrc/mine.cu``): one CTA an anchor of kDrawWarps warps, a gate pass
    of kDrawGate = 32 × kDrawWarps tiles, one frame tile a warp a round,
    the gate's tests, the counts entry's mask test on Bounds, the owner's
    ballot, and ``masks()`` (square root) left to the W₁ walk alone; the
    wrapper's constants are the kernel's."""
    assert "constexpr int kDrawTile = 32 * kDrawUnroll;" in SRC
    assert "constexpr int kDrawGate = 32 * kDrawWarps;" in SRC
    assert "static_assert(kDrawTile == 128," in SRC and TILE == 128
    assert (mk.DRAW_WARPS, mk.DRAW_GATE, mk.ROWS_PER_TILE) == (
        WARPS, GATE, TILE)
    assert "return neg ? s >= b.neg_lo_s && s <= b.neg_hi_s && gap >= " \
           "b.neg_gap\n             : s < b.pos_s && gap >= b.pos_gap;" in SRC
    assert "if (!neg) return s_lo >= b.pos_s;" in SRC
    assert "return s_hi < b.neg_lo_s || s_lo > b.neg_hi_s;" in SRC
    assert "box_sums(a, a, f, s_lo, s_hi);" in SRC        # the anchor's box
    assert "box_sums(a, a + 3, f, s_lo, s_hi);" in SRC    # skip_block's
    assert "hi[c] = fmaxf(fabsf(dlo), fabsf(dhi));" in SRC
    assert "const int t = g0 + threadIdx.x;" in SRC
    assert "if (keep) kept[at + __popc(kb & below)] = t;" in SRC
    assert ("const int j0 = k0 + warp < n_kept ? kept[k0 + warp] * kBJ : "
            "hi;") in SRC
    assert "const int j = j0 + 32 * q + lane;" in SRC
    assert "if (in[q] && __popc(m[q] & below) == rr - f)" in SRC
    assert SRC.count("<<<count, 32 * kDrawWarps, 0,") == 2
    assert len(re.findall(r"\bmasks\(pa,", SRC)) == 1       # the walk's


def test_tile_boxes_are_the_tiles():
    """``tile_boxes``: each 128-frame tile's min and max a column, the
    last tile short, NaN where a tile holds a NaN."""
    positions = city(n=1_000)
    positions[300, 2] = np.nan
    got = mk.tile_boxes(torch.from_numpy(positions)).numpy()
    np.testing.assert_array_equal(got, boxes_np(positions))
    assert got.shape == (8, 6) and np.isnan(got[2, [2, 5]]).all()
    assert not np.isnan(np.delete(got, 2, axis=0)).any()


def test_draw_rounds_counts_the_walk():
    """``draw_rounds`` where the gate keeps every tile (every frame at the
    anchors' place): one split of 517 tiles, so three gate passes; rounds
    of kDrawWarps tiles counted on across the passes, the tiles of the
    rounds read, the kept tiles before the member's, and the gated work
    (every tile kept, so every frame up to the member)."""
    tiles = 2 * GATE + 5
    n = tiles * TILE
    positions = np.zeros((n, 3), np.float32)
    idx = torch.tensor([0, TILE * WARPS - 1, TILE * WARPS, GATE * TILE + 3,
                        n - 1, 7])
    cnt = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.int32)
    got = mk.draw_rounds(torch.from_numpy(positions), 0, idx, cnt, SCALE,
                         "pos", 1)
    per_pass = GATE // WARPS
    last = 2 * per_pass + (tiles - 1 - 2 * GATE) // WARPS + 1
    rounds = [1, 1, 2, per_pass + 1, last]
    read = [WARPS, WARPS, 2 * WARPS, GATE + WARPS, tiles]
    assert got == {"model_rounds_mean": sum(rounds) / 5,
                   "model_rounds_max": last,
                   "model_frames_read": TILE * sum(read),
                   "model_tiles_kept_mean": (0 + WARPS - 1 + WARPS + GATE
                                             + tiles - 1) / 5,
                   "model_tiles_tested": sum(int(i) // TILE + 1
                                             for i in idx[:5]),
                   "model_frames_needed": sum(int(i) + 1 for i in idx[:5]),
                   "model_tiles_touched": tiles,
                   "model_frames_touched": n}
