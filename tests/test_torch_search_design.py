"""Numpy models of the verifier's two search kernels as ``csrc/nearest.cu``
(kernel N) and ``csrc/knn.cu`` (kernel K) split their work, against the
plain versions (``nearest_plain``, ``knn_plain``) bit for bit on inputs
chosen where the split could go wrong: NaN before and after a finite
minimum, NaN only under the mask, equal targets on both sides of a group,
part, rank or tile boundary, P and Q off every multiple and Q below the
cluster split, rows with exactly k valid points, k = 1 to 32, rows whose
own batch is the last, partial one, several tiles, NaN candidates inside a
row's k.

The kernels run only on a card (``chip_smoke.py`` phase 3 holds them
against the plain versions there); these models hold their arithmetic and
their visiting order here. Each model reads its constants from the CUDA
source, and runs again with small tiles so that the tile loops are taken
at these sizes.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from neural_spectral_codec_torch.retrieval import (  # noqa: E402
    knn_kernel, nearest_kernel)

CSRC = REPO / "neural_spectral_codec_torch" / "csrc"
U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
NAN_BITS = np.uint32(0x7F800001)        # knn.cu kNanBits: NaN after +inf
PAD_INDEX = 0x7FFFFFFF                  # pairwise.cuh kPadIndex


def source_constants(name: str) -> dict:
    """The ``constexpr int kName = <literal>;`` lines of a CUDA source."""
    text = (CSRC / name).read_text()
    return {m[1]: int(m[2], 0) for m in re.finditer(
        r"constexpr (?:int|unsigned) (k\w+) = (0x[0-9a-fA-F]+|\d+)u?;", text)}


N_SRC = source_constants("nearest.cu")
K_SRC = source_constants("knn.cu")


# -- the shared entries (pairwise.cuh search_entry, pad_entry) ------------

def entries(pts: np.ndarray, mask: np.ndarray, padded: int):
    """(xyz (padded, 3), index, valid) as the kernels stage a tile: the
    mask folded into the point, padding at NaN with the largest index."""
    n = len(pts)
    xyz = np.full((padded, 3), np.nan, np.float32)
    xyz[:n] = np.where(mask[:, None], pts,
                       np.array([np.inf, 0, 0], np.float32))
    index = np.full(padded, PAD_INDEX, np.int64)
    index[:n] = np.arange(n)
    valid = np.ones(padded, bool)
    valid[:n] = mask
    return xyz, index, valid


def sq_dist(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(dx² + dy²) + dz², each operation rounded to float32 (no FMA)."""
    with np.errstate(invalid="ignore", over="ignore"):
        d = (p[..., None, :] - q).astype(np.float32)
        sq = d * d
        return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def entry_d2(p, xyz, valid):
    """The exact distance from any point: +inf for a masked entry."""
    return np.where(valid, sq_dist(p, xyz), np.float32(np.inf))


def bits(d: np.ndarray) -> np.ndarray:
    return np.asarray(d, np.float32).view(np.uint32)


# -- kernel N ------------------------------------------------------------

def argmin_key(d: np.ndarray, j: np.ndarray) -> np.ndarray:
    """NaN first, then the distance, then the index (nearest.cu)."""
    hi = np.where(np.isnan(d), np.uint32(0), bits(d) + np.uint32(1))
    return (hi.astype(np.uint64) << np.uint64(32)) | j.astype(np.uint64)


def nearest_split(n_src: int, n_dst: int, tile=None) -> tuple:
    """(CTAs, [(rank, tile base, lo, hi) of every part a warp scans]) as
    ``nsc_nearest`` launches and ``nearest_kernel`` splits: clusters of
    kCluster CTAs for kRows · 32 rows each; rank r takes targets
    [r·Q/C, (r+1)·Q/C) in tiles, each tile cut into kParts parts of whole
    groups (some empty)."""
    c = N_SRC
    cluster, group, parts = c["kCluster"], c["kGroup"], c["kParts"]
    tile = tile or c["kTile"]
    ctas = -(-n_src // (32 * c["kRows"])) * cluster
    spans = []
    for rank in range(cluster):
        lo, hi = rank * n_dst // cluster, (rank + 1) * n_dst // cluster
        for base in range(lo, hi, tile):
            n = min(tile, hi - base)
            span = -(-n // (parts * group)) * group   # whole groups
            spans += [(rank, base, p * span, min(n, p * span + span))
                      for p in range(parts) if p * span < n]
    return ctas, spans


def nearest_model(src, dst, mask, tile=None):
    """kernel N's result. Per part of a tile, the common path (group
    minima by fmin, strict improvement: the key (bits of the least
    distance, its group)) or the exact path (64-bit argmin keys), as the
    lane's two points and the tile decide; per tile the least part key,
    on the common path searched again in its group for the first target
    at that distance; the tiles' and ranks' keys merged by their
    minimum."""
    c = N_SRC
    group, rows = c["kGroup"], c["kRows"]
    tile = tile or c["kTile"]
    n_src, n_dst = len(src), len(dst)
    _, spans = nearest_split(n_src, n_dst, tile)
    # lane l of CTA block b holds rows b·64 + l + 32 r, r < kRows
    per_cta = 32 * rows
    fin = np.ones(-(-n_src // per_cta) * per_cta, bool)
    fin[:n_src] = np.isfinite(src).all(1)
    lane_finite = fin.reshape(-1, rows, 32).all(1)
    row_finite = np.repeat(lane_finite[:, None, :], rows, 1).reshape(-1)[
        :n_src]
    key = np.full(n_src, U64_MAX)
    tiles = {}
    for rank, base, t_lo, t_hi in spans:
        tiles.setdefault((rank, base), []).append((t_lo, t_hi))
    for (rank, base), parts in tiles.items():
        n = min(tile, (rank + 1) * n_dst // c["kCluster"] - base)
        xyz, index, valid = entries(dst[base:base + n], mask[base:base + n],
                                    -(-n // group) * group)
        index[:n] += base
        exact = (valid[:n] & ~np.isfinite(xyz[:n]).all(1)).any() | \
            ~row_finite
        part_keys = []
        for t_lo, t_hi in parts:
            d_ex = entry_d2(src, xyz[t_lo:t_hi], valid[t_lo:t_hi])
            k_ex = argmin_key(d_ex, np.broadcast_to(index[t_lo:t_hi],
                                                    d_ex.shape)).min(1)
            d = sq_dist(src, xyz[t_lo:-(-t_hi // group) * group])
            m = np.fmin.reduce(d.reshape(n_src, -1, group), axis=2)
            best = np.full(n_src, np.inf, np.float32)
            grp = np.full(n_src, t_lo)
            for g in range(m.shape[1]):
                upd = m[:, g] < best
                best[upd], grp[upd] = m[upd, g], t_lo + g * group
            k_fast = (bits(best).astype(np.uint64) << np.uint64(32)) | \
                grp.astype(np.uint64)
            part_keys.append(np.where(exact, k_ex, k_fast))
        k_tile = np.minimum.reduce(part_keys)
        for r in np.flatnonzero(~exact):
            best = np.uint32(int(k_tile[r]) >> 32).view(np.float32)
            g = int(k_tile[r]) & 0xFFFFFFFF
            d = sq_dist(src[r], xyz[g:g + group])
            k_tile[r] = argmin_key(best, index[g + np.flatnonzero(
                d == best)[0]])
        key = np.minimum(key, k_tile)
    hi = (key >> np.uint64(32)).astype(np.uint32)
    d2 = np.where(hi == 0, np.uint32(0x7FFFFFFF), hi - np.uint32(1)).view(
        np.float32)
    return (key & np.uint64(0xFFFFFFFF)).astype(np.int64), d2


def nearest_inputs(case: str):
    """(src, dst, mask) of one hard case, from a fixed seed (P, Q ≤ 300)."""
    rng = np.random.default_rng(7)
    n_src, n_dst = 200, 280
    if case == "q_below_split":
        n_dst = 5
    elif case == "q_1":
        n_dst = 1
    elif case == "p_1":
        n_src = 1
    elif case == "p257_q37":
        n_src, n_dst = 257, 37
    src = rng.uniform(-5, 5, (n_src, 3)).astype(np.float32)
    dst = rng.uniform(-5, 5, (n_dst, 3)).astype(np.float32)
    mask = rng.random(n_dst) < 0.85
    if case == "nan_after_minimum":
        mask[:] = True
        dst[250] = np.nan
    elif case == "nan_before_minimum":
        mask[:] = True
        dst[3, 1] = np.nan
        dst[200, 0] = np.nan
    elif case == "nan_masked":
        dst[~mask] = np.nan
    elif case == "ties_across_seams":
        # at Q = 280 a rank holds 140 targets in parts of one group (8): a
        # group and part boundary (7|8, 63|64), the ranks' (139|140) and
        # parts of rank 1 (147|148, 203|204); with 16-entry tiles also
        # tile boundaries (15|16, 155|156)
        seams = [7, 15, 63, 139, 147, 155, 203]
        mask[:] = True
        for j in seams:
            dst[j + 1] = dst[j]
        near = 60 - len(seams)
        src[:len(seams)] = dst[seams]
        src[len(seams):60] = (dst[np.resize(seams, near)] + rng.uniform(
            -0.1, 0.1, (near, 3))).astype(np.float32)
    elif case == "nan_rows":
        src[[5, 77]] = np.nan
        src[9, 2] = np.nan
    elif case == "inf_points":
        src[3] = np.inf
        src[4, 0] = -np.inf
        dst[10] = [np.inf, 0, 0]
        mask[10] = True
    elif case == "overflow":
        src[:20] *= np.float32(3e19)      # squared differences overflow
    elif case == "all_masked":
        mask[:] = False
    return src, dst, mask


NEAREST_CASES = ["nan_after_minimum", "nan_before_minimum", "nan_masked",
                 "ties_across_seams", "q_below_split", "q_1", "p_1",
                 "p257_q37", "nan_rows", "inf_points", "overflow",
                 "all_masked"]


@pytest.mark.parametrize("tile", [None, 16])
@pytest.mark.parametrize("case", NEAREST_CASES)
def test_nearest_model_equals_plain(case, tile):
    """Kernel N's split (ranks, tiles, parts, groups; the source's tile and a
    16-entry tile) and its two paths give the plain version's indices and
    squared distances bit for bit."""
    src, dst, mask = nearest_inputs(case)
    j, d2 = nearest_model(src, dst, mask, tile)
    jp, d2p = nearest_kernel.nearest_plain(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask))
    np.testing.assert_array_equal(j, jp.numpy())
    nan = np.isnan(d2p.numpy())
    np.testing.assert_array_equal(np.isnan(d2), nan)
    np.testing.assert_array_equal(bits(d2[~nan]), bits(d2p.numpy()[~nan]))


@pytest.mark.parametrize("n_src,n_dst", [(1, 1), (1, 7), (300, 5),
                                         (257, 4097), (4096, 4096),
                                         (4096, 9000), (1000, 3001)])
def test_nearest_split_covers_every_pair(n_src, n_dst):
    """The launch and the split at P = 1, Q below the cluster split, P off
    a multiple of the CTA's 64 rows and several tiles a rank: the CTAs
    cover P, and the parts cover [0, Q) once, in order, each starting on
    a whole group of its tile, at most kParts a tile."""
    c = N_SRC
    ctas, spans = nearest_split(n_src, n_dst)
    per_cluster = 32 * c["kRows"]
    assert ctas % c["kCluster"] == 0
    assert (ctas // c["kCluster"] - 1) * per_cluster < n_src <= \
        ctas // c["kCluster"] * per_cluster
    cover = [(base + lo, base + hi) for _, base, lo, hi in spans]
    assert cover[0][0] == 0 and cover[-1][1] == n_dst
    assert all(a[1] == b[0] for a, b in zip(cover, cover[1:]))
    assert all(lo % c["kGroup"] == 0 for _, _, lo, _ in spans)
    per_tile = {}
    for rank, base, _, _ in spans:
        per_tile[rank, base] = per_tile.get((rank, base), 0) + 1
    assert max(per_tile.values()) <= c["kParts"]


# -- kernel K ------------------------------------------------------------

def kth_distance(kth: np.uint64) -> np.float32:
    """knn.cu test_distance: the k-th key's distance, NaN while it is NaN
    or empty (every batch then goes to the exact test)."""
    hi = np.uint32(int(kth) >> 32)
    return hi.view(np.float32) if hi <= 0x7F800000 else np.float32(np.nan)


def keys_of(d, index):
    """knn.cu order_key: the distance (NaN after +inf), then the index."""
    return (np.minimum(bits(d), NAN_BITS).astype(np.uint64)
            << np.uint64(32)) | index.astype(np.uint64)


def knn_model(pts, mask, k, tile=None, rotate=True, counts=None):
    """kernel K's result: one row at a time (a CTA's rows share their
    tiles and their own batch, a warp's kRows rows the exact path), its
    tiles from its own, in each the batches out from its own batch (batch
    0 in the other tiles) both ways in turn; a batch passes the 32-bit
    test !(d2 > k-th distance), then the exact 64-bit test; at most
    kInsertMax passes are inserted one by one, more merged whole.
    ``rotate=False`` visits the batches in index order (the parent
    design's order)."""
    c = K_SRC
    tile = tile or c["kTile"]
    rows, insert_max = c["kRows"], c["kInsertMax"]
    per_cta = rows * c["kWarps"]
    n = len(pts)
    # warp w of a CTA holds rows w + kWarps r of its kRowsPerCta rows
    fin = np.ones(-(-n // per_cta) * per_cta, bool)
    fin[:n] = np.isfinite(pts).all(1)
    warp_finite = np.tile(fin.reshape(-1, rows, c["kWarps"]).all(1)[:, None],
                          (1, rows, 1)).reshape(-1)
    n_tiles = -(-n // tile)
    tiles = []
    for t in range(n_tiles):
        base = t * tile
        m = min(tile, n - base)
        xyz, index, valid = entries(pts[base:base + m], mask[base:base + m],
                                    -(-m // 32) * 32)
        index[:m] += base
        tiles.append((base, xyz, index, valid))
    out = np.empty((n, k), np.int64)
    for row in range(n):
        p = pts[row]
        finite = warp_finite[row]
        lst = np.full(32, U64_MAX)
        kth, kth_d2 = U64_MAX, np.float32(np.nan)
        own = row // per_cta * per_cta // tile if rotate else 0
        for s in range(n_tiles):
            base, xyz, index, valid = tiles[(own + s) % n_tiles]
            d_all = sq_dist(p, xyz) if finite else entry_d2(p, xyz, valid)
            nb = len(index) // 32
            first = (row // per_cta * per_cta - base) // 32 \
                if s == 0 and rotate else 0
            order = [(first + (i + 1) // 2 if i % 2 else first - i // 2) % nb
                     for i in range(nb)] if rotate else range(nb)
            for b in order:
                d = d_all[32 * b:32 * b + 32]
                if not (~(d > kth_d2)).any():
                    continue
                key = keys_of(d, index[32 * b:32 * b + 32])
                passed = key < kth
                if counts is not None:
                    counts["tested"] += 1
                    counts["passed"] += bool(passed.any())
                if not passed.any():
                    continue
                if passed.sum() > insert_max:
                    lst = np.sort(np.concatenate([lst, key]))[:32]
                else:
                    for cand in key[passed]:
                        pos = int((lst < cand).sum())
                        lst = np.concatenate([lst[:pos], [cand], lst[pos:31]])
                kth = lst[k - 1]
                kth_d2 = kth_distance(kth)
        out[row] = (lst[:k] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return out


def knn_inputs(case: str):
    """(pts, mask, k) of one hard case, from a fixed seed (P ≤ 300)."""
    rng = np.random.default_rng(11)
    n, k = 200, 20
    if case == "last_batch_partial":
        n = 77                      # rows 64-76: their own batch is partial
    elif case in ("nan_in_k", "nan_in_k_n24"):
        n, k = (40, 32) if case == "nan_in_k" else (24, 20)
    elif case == "exactly_k":
        n = 100
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    # sorted along x as a prepared cloud is (voxel key, x major)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    mask = rng.random(n) < 0.9
    if case.startswith("k") and case[1:].isdigit():
        k = int(case[1:])
    elif case == "exactly_k":
        mask[:] = False
        mask[rng.choice(n, 20, replace=False)] = True
    elif case.startswith("nan_in_k"):
        mask[:] = True
        pts[[j for j in (3, 5, 11, 17, 23, 33, 34, 36, 38, 39) if j < n]] \
            = np.nan
        pts[21, 1] = np.nan
    elif case == "nan_rows":
        pts[[5, 77]] = np.nan
        pts[9, 2] = np.nan
    elif case == "duplicates":
        pts[100:] = pts[:100]
        mask[:] = True
    elif case == "few_valid":
        mask[:] = False
        mask[[3, 17, 18, 40, 63, 190]] = True
    return pts, mask, k


KNN_CASES = ["k1", "k16", "k20", "k32", "exactly_k", "last_batch_partial",
             "nan_in_k", "nan_in_k_n24", "nan_rows", "duplicates",
             "few_valid"]


@pytest.mark.parametrize("tile", [None, 64])
@pytest.mark.parametrize("case", KNN_CASES)
def test_knn_model_equals_plain(case, tile):
    """Kernel K's visiting order (own batch first, its tile first; the
    source's tile and a 64-entry tile), its 32-bit test, the exact test
    and both ways of merging give the plain version's indices."""
    pts, mask, k = knn_inputs(case)
    want = knn_kernel.knn_plain(torch.from_numpy(pts),
                                torch.from_numpy(mask), k).numpy()
    np.testing.assert_array_equal(knn_model(pts, mask, k, tile), want)


def test_own_batch_first_tests_fewer_batches():
    """On a voxel-sorted cloud the own batch first leaves fewer batches
    for the exact test than index order, with the same answer."""
    from neural_spectral_codec_torch.data.synthetic import SyntheticLoader
    from neural_spectral_codec_torch.retrieval.verification import (
        _pad, voxel_downsample)
    frame = SyntheticLoader(n_frames=1, seed=41, n_points=20_000)[0]
    pts, mask = _pad(voxel_downsample(frame["points"], 1.0), 256)
    runs = {}
    for rotate in (True, False):
        counts = {"tested": 0, "passed": 0}
        runs[rotate] = (knn_model(pts, mask, 20, rotate=rotate,
                                  counts=counts), counts)
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    assert runs[True][1]["tested"] < runs[False][1]["tested"]


def test_constants_match_the_sources():
    """The wrappers' constants are the kernels' own."""
    assert nearest_kernel.CLUSTER == N_SRC["kCluster"]
    assert nearest_kernel.ROWS_PER_CTA == 32 * N_SRC["kRows"]
    assert knn_kernel.MAX_K == K_SRC["kMaxK"]
    assert K_SRC["kNanBits"] == int(NAN_BITS)
    assert N_SRC["kTile"] % N_SRC["kGroup"] == 0 and K_SRC["kTile"] % 32 == 0
