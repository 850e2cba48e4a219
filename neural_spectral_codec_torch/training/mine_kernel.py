"""One chunk of the triplet miner: its plain PyTorch version and the
binding of its hand-written kernel, ``csrc/mine.cu`` (kernel M), for each
of the three strategies.

It is no Pallas kernel's port: the JAX package leaves this work to XLA
inside its mining program (``neural_spectral_codec_tpu/training/miner.py``
``_mine_chunk``, :54-98): the positive and negative masks of a chunk of
anchors against every frame of the sequence, the tiled W₁ running argmin
over each anchor's negatives, and a draw among its positives. Per anchor
a = start .. start + count − 1 of a sequence (positions (n, 3), CDFs (n, B)
float32) it gives the positive and negative counts, the hard negative (the
least W₁ = Σ_b |cdf_a,b − cdf_j,b| over the negatives, summed over b in
increasing order, the lower index on a tie, index 0 when there is none),
``valid`` (a positive and a negative exist) and the positive: with u in
[0, 1) from the miner's generator, the r-th positive in index order, r =
min(⌊u · count_pos⌋, count_pos − 1). JAX's ``jax.random.categorical``
draws cannot be reproduced, only their support; this draw is uniform over
the same support.

``mine_plain`` computes the same with torch operations, frames in tiles of
``tile`` rows so that only (count, tile) temporaries exist, and sums W₁
bin by bin in the kernel's order: the two agree bit for bit. A CPU tensor
takes the plain version, a CUDA tensor the kernel (or the binding raises).
The kernel's header has its design and bound.

Kernel M's other three entries serve "semi-hard" and "random" (JAX
``_mine_chunk``, :99-111), each with its plain version, bit-equal to it:
``mine_rows`` (``rows_plain``) writes the chunk's (count, n) W₁ block, in
the same order, +inf outside each anchor's negatives, with the counts;
``mine_counts`` (``counts_plain``) gives the counts alone; ``mine_draw``
(``draw_plain``) takes the r-th member in index order of the positive or
the negative mask, r = min(⌊u · count⌋, count − 1), 0 when the count is 0.
On a card the draw reads the per-split counts that the entry before it
left in the scratch (``mine_scratch``), so both take the same scratch;
in the split that holds the member it reads only the frame tiles whose
box (``tile_boxes``, once a sequence) can hold one (``draw_gate``), in
rounds of DRAW_WARPS tiles (``draw_rounds``).

The counts entry and the draws test no distance: ``mask_bounds`` turns
the thresholds into bounds on the rounded sum of squares s and on the
integer gap that give the same masks (IEEE ``sqrt`` is correctly rounded
and monotone), and the counts entry skips each (128-anchor group,
128-frame tile) whose pairs provably hold no positive and no negative
(``tile_gate``: bounds on s from the two bounding boxes, in the pair
test's rounded operations).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

ANCHORS_PER_CTA = 128      # kBA in csrc/mine.cu
ROWS_PER_TILE = 128        # kBJ
CTAS_PER_SM = 2            # kCtasPerSm
TILE = 4096                # mine_plain's frames a tile
CPU_BLOCK = 1024           # w1_in_order's rows a block on the CPU
INT32_MAX = 2**31 - 1
DRAW_WARPS = 2             # kDrawWarps: a draw CTA's warps (one anchor)
DRAW_GATE = 32 * DRAW_WARPS   # kDrawGate: the tiles a draw's gate pass
# mask_bounds' five values as the C entries take them
_BOUNDS = [ctypes.c_float] * 3 + [ctypes.c_int] * 2


@functools.lru_cache(maxsize=None)
def _kernels() -> tuple:
    # bound at first use: the trainer imports this module, and importing
    # the package loads no kernel machinery
    from neural_spectral_codec_torch._build import CudaKernel
    return (CudaKernel("nsc_mine_hard", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, *[ctypes.c_float] * 5, ctypes.c_int,
        *[ctypes.c_void_p] * 7]),
        CudaKernel("nsc_mine_draw", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, *_BOUNDS, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]))


@functools.lru_cache(maxsize=None)
def _other_kernels() -> tuple:
    from neural_spectral_codec_torch._build import CudaKernel
    return (CudaKernel("nsc_mine_counts", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        *_BOUNDS, ctypes.c_int, *[ctypes.c_void_p] * 6]),
        CudaKernel("nsc_mine_rows", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, *[ctypes.c_float] * 5, ctypes.c_int,
            *[ctypes.c_void_p] * 7]),
        CudaKernel("nsc_mine_draw_mask", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, *_BOUNDS, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]))


_ENTRIES = {"HARD": (_kernels, 0), "DRAW": (_kernels, 1),
            "COUNTS": (_other_kernels, 0), "ROWS": (_other_kernels, 1),
            "DRAW_MASK": (_other_kernels, 2)}
WHICH = {"pos": 0, "neg": 1}        # the draw's masks


def __getattr__(name: str):
    # kernel M's five entries, each with its launch count: HARD (counts and
    # hard negatives), DRAW (the positive), COUNTS (the counts alone), ROWS
    # (the W₁ block) and DRAW_MASK (the draw over either mask)
    if name in _ENTRIES:
        table, i = _ENTRIES[name]
        return table()[i]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Counts(NamedTuple):
    """One chunk's int32 ``count_pos``, ``count_neg`` and bool ``valid``,
    each (count,)."""
    count_pos: torch.Tensor
    count_neg: torch.Tensor
    valid: torch.Tensor


class Mined(NamedTuple):
    """One chunk's per-anchor results: int32 ``pos_idx``, ``neg_idx``,
    ``count_pos``, ``count_neg`` and bool ``valid``, each (count,)."""
    pos_idx: torch.Tensor
    neg_idx: torch.Tensor
    count_pos: torch.Tensor
    count_neg: torch.Tensor
    valid: torch.Tensor


def chunk_masks(positions: torch.Tensor, a: torch.Tensor, j0: int,
                j1: int, params: Sequence[float]):
    """(pos, neg) masks (len(a), j1 − j0) of the anchors at global indices
    ``a`` against frames j0 .. j1 − 1: ‖a − p‖ from per-coordinate
    differences, (dx² + dy²) + dz² each rounded, then the correctly
    rounded float32 sqrt (computed in float64 and rounded once: PyTorch's
    CPU float32 ``sqrt`` is not correctly rounded on every value, its CUDA
    one and the kernel's ``__fsqrt_rn`` are); the temporal gap against the
    float32 thresholds."""
    rows = positions[j0:j1]
    pa = positions[a]
    d2 = None
    for c in range(positions.shape[1]):
        diff = pa[:, c, None] - rows[None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    d = torch.sqrt(d2.double()).float()
    gap = (a.to(torch.int32)[:, None] - torch.arange(
        j0, j1, dtype=torch.int32, device=a.device)[None, :]).abs()
    fgap = gap.to(torch.float32)
    not_self = gap > 0
    pos = (d < params[0]) & (fgap >= params[1]) & not_self
    neg = ((d >= params[2]) & (d <= params[3]) & (fgap >= params[4])
           & not_self)
    return pos, neg


def w1_in_order(acdf: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(len(acdf), len(rows)) W₁ sums, bin by bin in increasing order, each
    difference and sum rounded to float32 (the kernel's order). The bins
    become the leading axis once and the sum is added to in place; on the
    CPU the rows go in blocks of ``CPU_BLOCK``, so that the (count, block)
    sum stays in cache."""
    at = acdf.T.contiguous()
    block = CPU_BLOCK if acdf.device.type == "cpu" else max(len(rows), 1)
    out = []
    for r0 in range(0, len(rows), block):
        rt = rows[r0:r0 + block].T.contiguous()
        acc = (at[0][:, None] - rt[0][None, :]).abs_()
        tmp = torch.empty_like(acc)
        for b in range(1, at.shape[0]):
            acc.add_(torch.sub(at[b][:, None], rt[b][None, :],
                               out=tmp).abs_())
        out.append(acc)
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def mine_plain(positions: torch.Tensor, cdfs: torch.Tensor,
               start: Union[int, torch.Tensor], count: int,
               params: Sequence[float], u: torch.Tensor,
               tile: int = TILE) -> Mined:
    """Kernel M's function with torch operations, over frame tiles of
    ``tile`` rows (a running (W₁, index) min, strict <, so the earlier tile
    keeps a tie; NaN sums are never taken, as in the kernel)."""
    n = positions.shape[0]
    dev = positions.device
    a = _anchors(start, count, dev)
    acdf = cdfs[int(start):int(start) + count]
    inf = torch.tensor(float("inf"), device=dev)
    best = torch.full((count,), float("inf"), device=dev)
    best_i = torch.zeros(count, dtype=torch.int64, device=dev)
    cpos = torch.zeros(count, dtype=torch.int64, device=dev)
    cneg = torch.zeros(count, dtype=torch.int64, device=dev)
    for j0 in range(0, n, tile):
        j1 = min(j0 + tile, n)
        pos, neg = chunk_masks(positions, a, j0, j1, params)
        cpos += pos.sum(dim=1)
        cneg += neg.sum(dim=1)
        w1 = w1_in_order(acdf, cdfs[j0:j1])
        w1 = torch.where(neg & (w1 == w1), w1, inf)
        targ = w1.argmin(dim=1)
        tmin = w1.gather(1, targ[:, None])[:, 0]
        upd = tmin < best
        best = torch.where(upd, tmin, best)
        best_i = torch.where(upd, targ + j0, best_i)
    pos_i = _member(positions, a, params, u, cpos, 0, tile)
    i32 = torch.int32
    return Mined(pos_i.to(i32), best_i.to(i32), cpos.to(i32), cneg.to(i32),
                 (cpos > 0) & (cneg > 0))


def _member(positions: torch.Tensor, a: torch.Tensor,
            params: Sequence[float], u: torch.Tensor, cnt: torch.Tensor,
            which: int, tile: int) -> torch.Tensor:
    """For each anchor of ``a`` the r-th member in index order of its
    positive (``which`` 0) or negative (1) mask, r = min(⌊u · cnt⌋, cnt −
    1) in float32, 0 where ``cnt`` is 0; int64, the frames in tiles."""
    n, dev = positions.shape[0], positions.device
    cnt = cnt.to(torch.int64)
    r = torch.minimum(torch.floor(u * cnt.to(torch.float32)).to(
        torch.int64), cnt - 1)
    out = torch.zeros(len(a), dtype=torch.int64, device=dev)
    seen = torch.zeros(len(a), dtype=torch.int64, device=dev)
    found = cnt == 0
    for j0 in range(0, n, tile):
        m = chunk_masks(positions, a, j0, min(j0 + tile, n), params)[which]
        at = m & (torch.cumsum(m, dim=1) + seen[:, None] == r[:, None] + 1)
        hit = at.any(dim=1) & ~found
        out = torch.where(hit, at.to(torch.uint8).argmax(dim=1) + j0, out)
        found |= hit
        seen += m.sum(dim=1)
    return out


def _anchors(start, count: int, dev) -> torch.Tensor:
    s = int(start)
    return torch.arange(s, s + count, dtype=torch.int64, device=dev)


def _counts(cpos: torch.Tensor, cneg: torch.Tensor) -> Counts:
    return Counts(cpos.to(torch.int32), cneg.to(torch.int32),
                  (cpos > 0) & (cneg > 0))


def counts_plain(positions: torch.Tensor, start: Union[int, torch.Tensor],
                 count: int, params: Sequence[float],
                 tile: int = TILE) -> Counts:
    """The counts entry's function with torch operations: the positive
    and negative counts of anchors ``start .. start + count`` and
    ``valid``, the frames in tiles of ``tile``."""
    n, dev = positions.shape[0], positions.device
    a = _anchors(start, count, dev)
    cpos = torch.zeros(count, dtype=torch.int64, device=dev)
    cneg = torch.zeros(count, dtype=torch.int64, device=dev)
    for j0 in range(0, n, tile):
        pos, neg = chunk_masks(positions, a, j0, min(j0 + tile, n), params)
        cpos += pos.sum(dim=1)
        cneg += neg.sum(dim=1)
    return _counts(cpos, cneg)


class MaskBounds(NamedTuple):
    """The counts entry's thresholds (``mask_bounds``). For a pair's
    rounded sum of squares s (+0 to +inf, or NaN) and its integer gap g
    (0 ≤ g < 2³¹ − 1), the masks of ``chunk_masks`` are
        positive ⇔ s < pos_s and g ≥ pos_gap
        negative ⇔ s ≥ neg_lo_s and s ≤ neg_hi_s and g ≥ neg_gap
    (a NaN bound fails every comparison, as a NaN threshold does; the
    gaps' bounds are at least 1, which is the test g > 0)."""
    pos_s: float
    neg_lo_s: float
    neg_hi_s: float
    pos_gap: int
    neg_gap: int


_INF_BITS = 0x7F800000     # +inf's bits: the last non-negative float32


def _f32(bits: int) -> np.float32:
    return np.array(bits, np.uint32).view(np.float32)[()]


def sqrt_least(t: float) -> np.float32:
    """The least float32 s in [+0, +inf] with sqrt(s) ≥ t (float32 sqrt,
    correctly rounded), by bisection over the bit patterns; NaN for a NaN
    t. Since sqrt is monotone, for every s ≥ +0 and NaN: sqrt(s) < t ⇔
    s < L and sqrt(s) ≥ t ⇔ s ≥ L."""
    t = np.float32(t)
    if np.isnan(t):
        return np.float32(np.nan)
    lo, hi = 0, _INF_BITS            # sqrt(+inf) = +inf ≥ t: hi holds
    while lo < hi:
        mid = (lo + hi) // 2
        if np.sqrt(_f32(mid)) >= t:
            hi = mid
        else:
            lo = mid + 1
    return _f32(lo)


def sqrt_greatest(t: float) -> np.float32:
    """The greatest float32 s in [+0, +inf] with sqrt(s) ≤ t, by bisection
    over the bit patterns; NaN where there is none (t NaN or below 0).
    For every s ≥ +0 and NaN: sqrt(s) ≤ t ⇔ s ≤ U."""
    t = np.float32(t)
    if not np.float32(0) <= t:       # NaN, or below sqrt(+0)
        return np.float32(np.nan)
    lo, hi = 0, _INF_BITS            # sqrt(+0) ≤ t: lo holds
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if np.sqrt(_f32(mid)) <= t:
            lo = mid
        else:
            hi = mid - 1
    return _f32(lo)


def gap_least(g: float) -> int:
    """The least int32 i ≥ 0 whose float32 value is ≥ g, by bisection: for
    every gap 0 .. 2³¹ − 2, float32(gap) ≥ g ⇔ gap ≥ G. Where no int32 is
    (g NaN or above 2³¹) it is 2³¹ − 1, which no gap of a sequence of at
    most 2³¹ − 1 frames reaches."""
    g = np.float32(g)
    if not np.float32(INT32_MAX) >= g:
        return INT32_MAX
    lo, hi = 0, INT32_MAX
    while lo < hi:
        mid = (lo + hi) // 2
        if np.float32(mid) >= g:
            hi = mid
        else:
            lo = mid + 1
    return lo


@functools.lru_cache(maxsize=64)
def mask_bounds(params: tuple) -> MaskBounds:
    """The thresholds (pos_max, pos_gap, neg_min, neg_max, neg_gap), each
    rounded to float32, as the bounds of ``MaskBounds``: the same masks
    with no square root and no int-to-float conversion."""
    p = [float(v) for v in params]
    return MaskBounds(float(sqrt_least(p[0])), float(sqrt_least(p[2])),
                      float(sqrt_greatest(p[3])), max(gap_least(p[1]), 1),
                      max(gap_least(p[4]), 1))


def _boxes(v: torch.Tensor, rows: int) -> tuple:
    """Per group of ``rows`` consecutive rows of v (m, 3): the per-column
    min and max, (groups, 3) each; a NaN in a group makes its column's
    min and max NaN."""
    groups = -(-v.shape[0] // rows)
    pad = groups * rows - v.shape[0]
    lo = torch.cat([v, v.new_full((pad, 3), float("inf"))])
    hi = torch.cat([v, v.new_full((pad, 3), -float("inf"))])
    return (lo.view(groups, rows, 3).amin(dim=1),
            hi.view(groups, rows, 3).amax(dim=1))


def tile_gate(positions: torch.Tensor, start: Union[int, torch.Tensor],
              count: int, bounds: MaskBounds) -> torch.Tensor:
    """(anchor groups, frame tiles) bool: which (ANCHORS_PER_CTA-anchor
    group, ROWS_PER_TILE-frame tile) blocks the counts entry tests, as
    ``csrc/mine.cu`` decides it. From the boxes of the group's anchors and
    the tile's frames, per coordinate dlo = amin − fmax and dhi = amax −
    fmin (rounded): every pair's rounded difference lies in [dlo, dhi],
    so |d| ≥ dlo where dlo > 0, ≥ −dhi where dhi < 0, else ≥ 0 (NaN where
    dlo or dhi is NaN), and |d| ≤ max(|dlo|, |dhi|); squared and summed
    in the pair test's rounded operations and order, these bound every
    pair's s from below (s_lo) and above (s_hi), rounding being monotone.
    A block is skipped where s_lo ≥ pos_s and (s_hi < neg_lo_s or s_lo >
    neg_hi_s): no pair can be a positive or a negative. A NaN s_lo (a NaN
    coordinate, or ∞ − ∞) makes the test false: the block is tested."""
    s = int(start)
    amin, amax = _boxes(positions[s:s + count], ANCHORS_PER_CTA)
    fmin, fmax = _boxes(positions, ROWS_PER_TILE)
    s_lo, s_hi = _box_sums(amin, amax, fmin, fmax)
    skip = (s_lo >= bounds.pos_s) & ((s_hi < bounds.neg_lo_s)
                                     | (s_lo > bounds.neg_hi_s))
    return ~skip


def _box_sums(amin, amax, fmin, fmax) -> tuple:
    """(s_lo, s_hi) (a, f): bounds on the rounded sum of squares of every
    pair of a point in box a (rows of amin, amax) and one in box f, as
    ``tile_gate`` describes them."""
    dlo = amin[:, None, :] - fmax[None, :, :]
    dhi = amax[:, None, :] - fmin[None, :, :]
    zero = torch.where(torch.isnan(dlo) | torch.isnan(dhi),
                       float("nan"), 0.0)
    low = torch.where(dlo > 0, dlo, torch.where(dhi < 0, -dhi, zero))
    high = torch.maximum(dlo.abs(), dhi.abs())

    def s_of(d):
        sq = d * d
        return (sq[..., 0] + sq[..., 1]) + sq[..., 2]

    return s_of(low), s_of(high)


def tile_boxes(positions: torch.Tensor) -> torch.Tensor:
    """(⌈n / ROWS_PER_TILE⌉, 6) float32, contiguous: each frame tile's box
    (min x, y, z, max x, y, z; NaN in a column where the tile holds a
    NaN), on the positions' device. The draws read it."""
    lo, hi = _boxes(positions, ROWS_PER_TILE)
    return torch.cat([lo, hi], dim=1).contiguous()


def draw_gate(positions: torch.Tensor, start: Union[int, torch.Tensor],
              count: int, bounds: MaskBounds, which: str) -> torch.Tensor:
    """(count, frame tiles) bool: the tiles the draw over ``which``'s mask
    reads for each anchor, as ``csrc/mine.cu`` (``skip_tile``) decides it:
    ``tile_gate``'s bounds with the anchor's position for the anchors'
    box; a positive draw skips a tile where s_lo ≥ pos_s, a negative one
    where s_hi < neg_lo_s or s_lo > neg_hi_s (a NaN s_lo skips none)."""
    s = int(start)
    a = positions[s:s + count]
    fmin, fmax = _boxes(positions, ROWS_PER_TILE)
    s_lo, s_hi = _box_sums(a, a, fmin, fmax)
    if which == "pos":
        return ~(s_lo >= bounds.pos_s)
    return ~((s_hi < bounds.neg_lo_s) | (s_lo > bounds.neg_hi_s))


def gate_pairs(positions: torch.Tensor, start: Union[int, torch.Tensor],
               count: int, params: Sequence[float], splits: int) -> dict:
    """What the counts entry's gate leaves on one chunk (``tile_gate``):
    the pairs of the blocks it tests (``kept``), all pairs (``pairs``), and
    per frame split (``split_frames``) the pairs tested."""
    n = positions.shape[0]
    keep = tile_gate(positions, start, count,
                     mask_bounds(tuple(params))).cpu()
    arows = torch.full((keep.shape[0],), ANCHORS_PER_CTA)
    arows[-1] = count - ANCHORS_PER_CTA * (keep.shape[0] - 1)
    frows = torch.full((keep.shape[1],), ROWS_PER_TILE)
    frows[-1] = n - ROWS_PER_TILE * (keep.shape[1] - 1)
    per_tile = (keep * arows[:, None]).sum(dim=0) * frows
    per_split = [int(per_tile[lo // ROWS_PER_TILE:-(-hi // ROWS_PER_TILE)]
                     .sum()) for lo, hi in split_frames(n, splits)]
    return {"kept": int(per_tile.sum()), "pairs": count * n,
            "per_split": per_split}


def rows_plain(positions: torch.Tensor, cdfs: torch.Tensor,
               start: Union[int, torch.Tensor], count: int,
               params: Sequence[float], out: Optional[torch.Tensor] = None,
               tile: int = TILE) -> tuple:
    """The W₁-row entry's function with torch operations: (the (count, n)
    float32 block, ``Counts``), the block W₁ summed bin by bin in the
    kernel's order where the frame is a negative of the anchor and +inf
    elsewhere, written into ``out`` when it is given."""
    n, dev = positions.shape[0], positions.device
    a = _anchors(start, count, dev)
    acdf = cdfs[int(start):int(start) + count]
    if out is None:
        out = torch.empty((count, n), dtype=torch.float32, device=dev)
    cpos = torch.zeros(count, dtype=torch.int64, device=dev)
    cneg = torch.zeros(count, dtype=torch.int64, device=dev)
    for j0 in range(0, n, tile):
        j1 = min(j0 + tile, n)
        pos, neg = chunk_masks(positions, a, j0, j1, params)
        cpos += pos.sum(dim=1)
        cneg += neg.sum(dim=1)
        out[:, j0:j1] = w1_in_order(acdf, cdfs[j0:j1]).masked_fill_(
            ~neg, float("inf"))
    return out, _counts(cpos, cneg)


def draw_plain(positions: torch.Tensor, start: Union[int, torch.Tensor],
               count: int, params: Sequence[float], u: torch.Tensor,
               counts: torch.Tensor, which: str, tile: int = TILE
               ) -> torch.Tensor:
    """The mask draw's function with torch operations: per anchor the
    r-th member in index order of its positive (``which`` "pos") or
    negative ("neg") mask, r = min(⌊u · count⌋, count − 1) with ``counts``
    that mask's counts, 0 when the count is 0; int32."""
    a = _anchors(start, count, positions.device)
    return _member(positions, a, params, u, counts, WHICH[which],
                   tile).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_splits(n: int, count: int, sm_count: int) -> int:
    """The kernel's frame splits (grid.x): as many as fit the chunk's
    anchor tiles into one wave of CTAS_PER_SM CTAs an SM (a second,
    partial wave would take as long as the first), at least one, at most
    one split a frame tile. The answer does not depend on it."""
    tiles = -(-count // ANCHORS_PER_CTA)
    return max(1, min(-(-n // ROWS_PER_TILE),
                      CTAS_PER_SM * sm_count // tiles))


def split_frames(n: int, splits: int) -> list:
    """The frames [lo, hi) of each split, in split order: split s takes
    the frame tiles ⌊T·s / splits⌋ .. ⌊T·(s + 1) / splits⌋ − 1 of the T =
    ⌈n / ROWS_PER_TILE⌉ tiles (the kernel's ``split_tile``)."""
    tiles = -(-n // ROWS_PER_TILE)
    return [(tiles * s // splits * ROWS_PER_TILE,
             min(tiles * (s + 1) // splits * ROWS_PER_TILE, n))
            for s in range(splits)]


def draw_frames(pos_idx: torch.Tensor, count_pos: torch.Tensor, n: int,
                splits: int) -> int:
    """The frames whose masks the draw entry needs on a chunk's result:
    for each anchor with a positive, its split's frames from the first to
    the drawn positive (the walk cannot stop sooner)."""
    lo = torch.tensor([a for a, _ in split_frames(n, splits)])
    p = pos_idx.cpu().to(torch.int64)
    first = lo[torch.searchsorted(lo, p, right=True) - 1]
    return int(((p - first + 1) * (count_pos.cpu() > 0)).sum())


def draw_rounds(positions: torch.Tensor, start: Union[int, torch.Tensor],
                idx: torch.Tensor, counts: torch.Tensor,
                params: Sequence[float], which: str, splits: int) -> dict:
    """The draw entry's walk on a chunk's result by its design's model
    (``idx`` drawn from ``which``'s mask, whose counts are ``counts``;
    nothing here is read from the kernel): per anchor with a member, the
    rounds its CTA takes (each pass of DRAW_GATE tiles of the member's
    split lists the tiles ``draw_gate`` keeps, read DRAW_WARPS a round)
    and the frames it reads; their mean and most, the total frames read
    and the tiles kept before the member's, on average. Beside them the
    work the gated function needs, for its bound: the tiles from the
    split's first to the member's, whose boxes are tested
    (``tiles_tested``), the frames of the kept ones up to the member
    (``frames_needed``), and over all anchors the distinct tested tiles
    (``tiles_touched``) and the distinct frames of the kept ones and of
    the anchors (``frames_touched``). Every key starts with ``model_``."""
    n = positions.shape[0]
    s0 = int(start)
    keep = draw_gate(positions.cpu(), s0, len(idx),
                     mask_bounds(tuple(float(v) for v in params)),
                     which).numpy()
    tiles = keep.shape[1]
    size = np.minimum(ROWS_PER_TILE, n - ROWS_PER_TILE * np.arange(tiles))
    t_lo = np.array([tiles * s // splits for s in range(splits + 1)])
    p = idx.cpu().numpy().astype(np.int64)
    rounds, read, before = [], 0, []
    tested, needed = 0, 0
    tested_any = np.zeros(tiles, bool)     # tiles any anchor tests
    frames = np.zeros(n, bool)             # their frames up to a member
    has = np.flatnonzero(counts.cpu().numpy() > 0)
    for a in has:
        tm = p[a] // ROWS_PER_TILE
        s = np.searchsorted(t_lo, tm, side="right") - 1
        first = t_lo[s]
        tested += tm - first + 1
        tested_any[first:tm + 1] = True
        k_up = first + np.flatnonzero(keep[a, first:tm])
        needed += int(size[k_up].sum()) + p[a] - ROWS_PER_TILE * tm + 1
        frames[(ROWS_PER_TILE * k_up[:, None]
                + np.arange(ROWS_PER_TILE)).ravel()] = True
        frames[ROWS_PER_TILE * tm:p[a] + 1] = True
        r = 0
        for g in range(first, t_lo[s + 1], DRAW_GATE):
            k = g + np.flatnonzero(keep[a, g:min(g + DRAW_GATE,
                                                 t_lo[s + 1])])
            if tm >= g + DRAW_GATE:              # a pass read in full
                r += -(-len(k) // DRAW_WARPS)
                read += int(size[k].sum())
                continue
            at = int(np.searchsorted(k, tm))     # the member's tile's place
            r += at // DRAW_WARPS + 1
            read += int(size[k[:(at // DRAW_WARPS + 1) * DRAW_WARPS]].sum())
            before.append(int(keep[a, first:tm].sum()))
            break
        rounds.append(r)
    frames[s0 + has] = True                      # the anchors' positions
    return {"model_rounds_mean": float(np.mean(rounds)) if rounds else 0.0,
            "model_rounds_max": int(np.max(rounds)) if rounds else 0,
            "model_frames_read": read,
            "model_tiles_kept_mean": (float(np.mean(before)) if before
                                      else 0.0),
            "model_tiles_tested": int(tested),
            "model_frames_needed": int(needed),
            "model_tiles_touched": int(tested_any.sum()),
            "model_frames_touched": int(frames.sum())}


def _check(t: torch.Tensor, shape: tuple, dtype, dev, what: str) -> None:
    from neural_spectral_codec_torch._build import check_contiguous
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"mine_cuda {what}: expected {shape} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != dev:
        raise ValueError(f"mine_cuda {what} on {t.device}, positions on "
                         f"{dev}")
    check_contiguous(t, f"mine_cuda {what}")


def _check_cdfs(cdfs: torch.Tensor, n: int, dev) -> None:
    _check(cdfs, (n, cdfs.shape[1] if cdfs.dim() == 2 else -1),
           torch.float32, dev, "cdfs")


def _check_boxes(boxes: torch.Tensor, n: int, dev) -> None:
    _check(boxes, (-(-n // ROWS_PER_TILE), 6), torch.float32, dev, "boxes")


def mine_scratch(n: int, count: int, device) -> tuple:
    """Kernel M's scratch for a (n, count) chunk on a card: the splits'
    partials (splits, count, 4) int32, which the draw entry reads after the
    first entry, and the anchor tiles' tickets (at 0)."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    splits = row_splits(n, count, _sm_count(index))
    return (torch.empty((splits, count, 4), dtype=torch.int32, device=dev),
            torch.zeros(-(-count // ANCHORS_PER_CTA), dtype=torch.int32,
                        device=dev))


def mine_cuda(positions: torch.Tensor, cdfs: torch.Tensor,
              start: torch.Tensor, count: int, params: Sequence[float],
              u: torch.Tensor, boxes: torch.Tensor,
              scratch: Optional[tuple] = None) -> Mined:
    """Launch kernel M's two entries on the card: positions (n, 3), cdfs
    (n, B), u (count,) float32 and start (1,) int32 (start + count ≤ n, read
    on the device), all on one card; ``boxes`` the positions'
    ``tile_boxes``; ``scratch`` is ``mine_scratch``'s (allocated here when
    None; a caller that launches the entries again by hand keeps it).
    Types, shapes and contiguity are checked first (``ValueError``,
    nothing launched)."""
    n, (partial, tickets) = _entry_checks(positions, start, count, scratch,
                                          "mine_cuda")
    dev = positions.device
    _check_cdfs(cdfs, n, dev)
    _check(u, (count,), torch.float32, dev, "u")
    _check_boxes(boxes, n, dev)
    splits = partial.shape[0]
    i32 = torch.int32
    out = Mined(*(torch.empty(count, dtype=i32, device=dev)
                  for _ in range(4)),
                torch.empty(count, dtype=torch.bool, device=dev))
    p = tuple(float(v) for v in params)
    hard, draw = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        hard(positions.data_ptr(), cdfs.data_ptr(), start.data_ptr(), n,
             count, cdfs.shape[1], *p, splits, partial.data_ptr(),
             tickets.data_ptr(), out.neg_idx.data_ptr(),
             out.count_pos.data_ptr(), out.count_neg.data_ptr(),
             out.valid.data_ptr(), stream)
        draw(positions.data_ptr(), boxes.data_ptr(), start.data_ptr(), n,
             count, *mask_bounds(p), u.data_ptr(),
             out.count_pos.data_ptr(), splits, partial.data_ptr(),
             out.pos_idx.data_ptr(), stream)
    return out


def mine(positions: torch.Tensor, cdfs: torch.Tensor, start, count: int,
         params: Sequence[float], u: torch.Tensor, boxes: torch.Tensor,
         tile: int = TILE) -> Mined:
    """Kernel M on CUDA tensors (``start`` a (1,) int32 device tensor;
    ``boxes`` as ``mine_cuda``'s), its plain version on CPU tensors
    (``tile`` frames a tile; ``boxes`` unused there)."""
    if positions.device.type == "cpu":
        return mine_plain(positions, cdfs, start, count, params, u, tile)
    return mine_cuda(positions, cdfs, start, count, params, u, boxes)


def _entry_checks(positions: torch.Tensor, start: torch.Tensor, count: int,
                  scratch: Optional[tuple], what: str) -> tuple:
    """The checks every entry's wrapper makes of the positions, start,
    count and scratch (``mine_scratch``'s, made here when None); returns
    (n, scratch)."""
    dev = positions.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    n = positions.shape[0]
    if not 1 <= count <= n:
        raise ValueError(f"{what}: count {count} outside 1 .. {n}")
    _check(positions, (n, 3), torch.float32, dev, "positions")
    _check(start, (1,), torch.int32, dev, "start")
    scratch = scratch or mine_scratch(n, count, dev)
    partial, tickets = scratch
    if (partial.shape[1:] != (count, 4) or partial.device != dev
            or tickets.shape != (-(-count // ANCHORS_PER_CTA),)):
        raise ValueError(f"{what}: scratch of another chunk (mine_scratch)")
    return n, scratch


def counts_cuda(positions: torch.Tensor, start: torch.Tensor, count: int,
                params: Sequence[float], scratch: Optional[tuple] = None
                ) -> Counts:
    """Launch kernel M's counts entry on the card (shapes and types as
    ``mine_cuda``'s) with the thresholds as ``mask_bounds``; ``scratch``
    receives the per-split counts that ``draw_cuda`` reads."""
    n, (partial, tickets) = _entry_checks(positions, start, count, scratch,
                                          "counts_cuda")
    dev = positions.device
    out = Counts(torch.empty(count, dtype=torch.int32, device=dev),
                 torch.empty(count, dtype=torch.int32, device=dev),
                 torch.empty(count, dtype=torch.bool, device=dev))
    with torch.cuda.device(dev):
        _other_kernels()[0](
            positions.data_ptr(), start.data_ptr(), n, count,
            *mask_bounds(tuple(float(v) for v in params)), partial.shape[0],
            partial.data_ptr(), tickets.data_ptr(), out.count_pos.data_ptr(),
            out.count_neg.data_ptr(), out.valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return out


def rows_cuda(positions: torch.Tensor, cdfs: torch.Tensor,
              start: torch.Tensor, count: int, params: Sequence[float],
              out: torch.Tensor, scratch: Optional[tuple] = None) -> Counts:
    """Launch kernel M's W₁-row entry on the card: ``out`` (count, n)
    float32, contiguous, receives the block; returns the counts.
    ``scratch`` receives the per-split counts that ``draw_cuda`` reads."""
    n, (partial, tickets) = _entry_checks(positions, start, count, scratch,
                                          "rows_cuda")
    dev = positions.device
    _check_cdfs(cdfs, n, dev)
    _check(out, (count, n), torch.float32, dev, "out")
    res = Counts(torch.empty(count, dtype=torch.int32, device=dev),
                 torch.empty(count, dtype=torch.int32, device=dev),
                 torch.empty(count, dtype=torch.bool, device=dev))
    with torch.cuda.device(dev):
        _other_kernels()[1](
            positions.data_ptr(), cdfs.data_ptr(), start.data_ptr(), n,
            count, cdfs.shape[1], *[float(v) for v in params],
            partial.shape[0], partial.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), res.count_pos.data_ptr(),
            res.count_neg.data_ptr(), res.valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return res


def draw_cuda(positions: torch.Tensor, start: torch.Tensor, count: int,
              params: Sequence[float], u: torch.Tensor, counts: torch.Tensor,
              which: str, scratch: tuple, boxes: torch.Tensor
              ) -> torch.Tensor:
    """Launch kernel M's mask draw on the card: ``u`` (count,) float32,
    ``counts`` (count,) int32 the mask's counts and ``scratch`` as the
    entry launched before it (``counts_cuda``, ``rows_cuda`` or
    ``mine_cuda``) left it; the thresholds as ``mask_bounds``, ``boxes``
    the positions' ``tile_boxes``; int32 (count,) out."""
    if scratch is None:
        raise ValueError("draw_cuda: needs the scratch of the entry before "
                         "it")
    n, (partial, _) = _entry_checks(positions, start, count, scratch,
                                    "draw_cuda")
    dev = positions.device
    _check(u, (count,), torch.float32, dev, "u")
    _check(counts, (count,), torch.int32, dev, "counts")
    _check_boxes(boxes, n, dev)
    out = torch.empty(count, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _other_kernels()[2](
            positions.data_ptr(), boxes.data_ptr(), start.data_ptr(), n,
            count,
            *mask_bounds(tuple(float(v) for v in params)), WHICH[which],
            u.data_ptr(),
            counts.data_ptr(), partial.shape[0], partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return out


def mine_counts(positions: torch.Tensor, start, count: int,
                params: Sequence[float], scratch: Optional[tuple] = None,
                tile: int = TILE) -> Counts:
    """Kernel M's counts entry on CUDA tensors, its plain version on CPU
    tensors (``scratch`` unused there)."""
    if positions.device.type == "cpu":
        return counts_plain(positions, start, count, params, tile)
    return counts_cuda(positions, start, count, params, scratch)


def mine_rows(positions: torch.Tensor, cdfs: torch.Tensor, start,
              count: int, params: Sequence[float], out: torch.Tensor,
              scratch: Optional[tuple] = None, tile: int = TILE) -> Counts:
    """Kernel M's W₁-row entry on CUDA tensors, its plain version on CPU
    tensors: the block into ``out``, the counts returned."""
    if positions.device.type == "cpu":
        return rows_plain(positions, cdfs, start, count, params, out,
                          tile)[1]
    return rows_cuda(positions, cdfs, start, count, params, out, scratch)


def mine_draw(positions: torch.Tensor, start, count: int,
              params: Sequence[float], u: torch.Tensor, counts: torch.Tensor,
              which: str, boxes: torch.Tensor,
              scratch: Optional[tuple] = None, tile: int = TILE
              ) -> torch.Tensor:
    """Kernel M's mask draw on CUDA tensors (after an entry that filled
    ``scratch``; ``boxes`` as ``draw_cuda``'s), its plain version on CPU
    tensors (``boxes`` and ``scratch`` unused there)."""
    if positions.device.type == "cpu":
        return draw_plain(positions, start, count, params, u, counts, which,
                          tile)
    return draw_cuda(positions, start, count, params, u, counts, which,
                     scratch, boxes)
