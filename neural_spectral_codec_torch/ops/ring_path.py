"""Ring-structured projection: ring-major scans → range images.

Port of ``neural_spectral_codec_tpu/ops/ring_path.py``. Spinning LiDARs
emit points ring-major with azimuth monotone within each ring; for input
shaped ``(B, R, P, 3|4)`` that meets the structure contract (C1: every
valid point of ring r lies in image row ``row_of_ring[r]``; C2: at most
``n_folds − 1`` wrap events per ring; C3: ``row_of_ring`` strictly
increasing), the image is

    image[b, row_of_ring[r], az_bin] = min range over the KEPT valid
                                       points of ring r in that bin.

Walk a ring's valid points in order. A wrap event is a valid point whose
azimuth bin is strictly less than the previous valid point's bin; the
first valid point is never one. A point is kept while at most
``n_folds − 1`` events have occurred up to and including it, so with the
default ``n_folds = 2`` everything from the second wrap event on is
dropped (JAX ``_ring_run_starts``, ring_path.py:106-200).

``project_rings_batch`` is the wrapper of the CUDA kernel
(``csrc/ring_fold.cu``, replacing ``pallas_ring._ring_fold_kernel`` fused
with ``_ring_keys``, ``_fold_min`` and the row placement): a CPU tensor
takes the plain version, a CUDA tensor the kernel. The TPU-only stage
depth bounds (``stage_bounds``, ``ring_stage_bounds``) have no
counterpart: the GPU kernel has no doubling loops to bound.

``encode_structured`` takes a flat sensor stream (KITTI sweep order,
NCLT or HeLiPR firing order) with per-point ring ids to the ring path
when the contract holds and to the general path otherwise; the host
helpers that recover ring ids and rows are numpy, copied from the JAX
module.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.ops.range_image import (
    ProjectionConfig, _spherical, _valid_mask, azimuth_bins, check_points,
    pad_points)
from neural_spectral_codec_torch.ops.spectral import Alpha, encode_images


def check_rows(row_of_ring: Sequence[int], n_rings: int,
               config: ProjectionConfig) -> Tuple[int, ...]:
    """Validate ``row_of_ring`` (C3) and return it as a tuple of ints."""
    rows = tuple(int(v) for v in row_of_ring)
    if list(rows) != sorted(set(rows)):
        raise ValueError("row_of_ring must be strictly increasing (C3); "
                         "sort rings by elevation on the host first")
    if rows and (rows[0] < 0 or rows[-1] >= config.n_elevation):
        raise ValueError("row_of_ring outside [0, n_elevation)")
    if n_rings != len(rows):
        raise ValueError(f"{n_rings} rings but {len(rows)} row assignments")
    return rows


def _ring_keys(points: torch.Tensor, config: ProjectionConfig):
    """(B, R, P, 3|4) → (range with +inf at invalid, azimuth bin int64
    with −1 at invalid). Same gates and formulas as the general path
    (JAX ``_ring_keys``, ring_path.py:73-103)."""
    rng, azimuth, elevation, finite = _spherical(points)
    valid = _valid_mask(rng, elevation, finite, config)
    key = torch.where(valid, azimuth_bins(azimuth, config.n_azimuth), -1)
    vals = torch.where(valid, rng, math.inf)
    return vals, key


def wrap_folds(key: torch.Tensor, n_folds: int):
    """The fold rule along the last axis of int64 bins (−1 = invalid):
    returns ``(keep, fold)``, ``fold`` the number of wrap events up to and
    including each position and ``keep`` the valid positions with
    ``fold <= n_folds − 1`` (module docstring)."""
    valid = key >= 0
    pos = torch.arange(key.shape[-1], device=key.device)
    # index of the last valid point at or before each position
    last = torch.where(valid, pos, -1).cummax(dim=-1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]],
                     dim=-1)
    prev_key = torch.gather(key, -1, prev.clamp(min=0))
    event = valid & (prev >= 0) & (key < prev_key)
    fold = event.cumsum(dim=-1)
    return valid & (fold <= n_folds - 1), fold


def ring_rows_plain(points: torch.Tensor, config: ProjectionConfig,
                    n_folds: int = 2) -> torch.Tensor:
    """(B, R, P, 3|4) → (B, R, n_azimuth): each ring's own row, the min
    range of its kept valid points per azimuth bin (0 = empty). This is
    what ``pallas_ring.ring_fold_pallas`` followed by ``_fold_min``
    computes."""
    check_points(points, 4, "ring_rows")
    b, n_rings = points.shape[:2]
    vals, key = _ring_keys(points, config)
    keep, _ = wrap_folds(key, n_folds)
    n_az = config.n_azimuth
    base = torch.arange(b * n_rings, device=points.device).reshape(
        b, n_rings, 1) * n_az
    target = torch.where(keep, key + base, b * n_rings * n_az)   # dump slot
    buf = torch.full((b * n_rings * n_az + 1,), math.inf,
                     dtype=torch.float32, device=points.device)
    buf.scatter_reduce_(0, target.reshape(-1),
                        torch.where(keep, vals, math.inf).reshape(-1), "amin")
    rows = buf[:-1].reshape(b, n_rings, n_az)
    return torch.where(torch.isinf(rows), 0.0, rows)


def project_rings_batch_plain(points: torch.Tensor, config: ProjectionConfig,
                              row_of_ring: Sequence[int],
                              n_folds: int = 2) -> torch.Tensor:
    """Plain PyTorch version of the ring kernel: (B, R, P, 3|4) →
    (B, n_elevation, n_azimuth); image row ``row_of_ring[r]`` holds ring
    r, rows without a ring are 0."""
    rows = check_rows(row_of_ring, points.shape[1], config)
    ring_rows = ring_rows_plain(points, config, n_folds)
    img = torch.zeros((points.shape[0], config.n_elevation,
                       config.n_azimuth), dtype=torch.float32,
                      device=points.device)
    img[:, list(rows)] = ring_rows
    return img


def project_rings_batch(points: torch.Tensor, config: ProjectionConfig,
                        row_of_ring: Sequence[int],
                        n_folds: int = 2) -> torch.Tensor:
    """(B, R, P, 3|4) ring-structured float32 clouds → (B, n_elevation,
    n_azimuth) range images, equal to ``project_points_batch`` on the
    flattened points for inputs meeting C1-C3. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel
    (``ops/ring_kernel.py``); any other device raises."""
    if points.device.type == "cpu":
        return project_rings_batch_plain(points, config, row_of_ring,
                                         n_folds)
    from neural_spectral_codec_torch.ops.ring_kernel import project_rings_cuda
    return project_rings_cuda(points, config, row_of_ring, n_folds)


def encode_points_ring_batch(points: torch.Tensor, alpha: Alpha, config,
                             row_of_ring: Sequence[int],
                             n_folds: int = 2) -> torch.Tensor:
    """Ring-structured variant of ``spectral.encode_points_batch``:
    (B, R, P, 3|4) → (B, output_dim) descriptors (JAX
    ``encode_points_ring_batch``, ring_path.py:301)."""
    imgs = project_rings_batch(points, config.projection, row_of_ring,
                               n_folds)
    return encode_images(imgs, alpha, config)


# ---------------------------------------------------------------------------
# host-side helpers, numpy (copied from the JAX package's ring_path.py)
# ---------------------------------------------------------------------------

def ring_elevation_centers(config: ProjectionConfig,
                           n_rings: int) -> np.ndarray:
    """Ring elevation angles at the centers of the image's first
    ``n_rings`` elevation bins (radians, increasing). Copied from JAX
    ``ring_path.ring_elevation_centers`` (ring_path.py:334)."""
    lo, hi = config.elevation_min, config.elevation_max
    step = (hi - lo) / config.n_elevation
    return lo + step * (np.arange(n_rings) + 0.5)


def _elev_gate_np(valid: np.ndarray, elev: np.ndarray,
                  config: ProjectionConfig) -> np.ndarray:
    """Host-side drop-mode elevation gate (no-op in clip mode)."""
    if config.elevation_mode == "drop":
        valid = valid & (elev >= config.elevation_min) \
            & (elev <= config.elevation_max)
    return valid


def _elevation_np(xs: np.ndarray, ys: np.ndarray,
                  zs: np.ndarray) -> np.ndarray:
    return np.arctan2(zs, np.sqrt(np.clip(xs * xs, 0, 1e10)
                                  + np.clip(ys * ys, 0, 1e10)))


def _finite_xyz(pts: np.ndarray):
    """(finite, x, y, z) with the stand-ins of ``_spherical`` at
    non-finite points."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    finite = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    return (finite, np.where(finite, x, 1.0), np.where(finite, y, 0.0),
            np.where(finite, z, 0.0))


def ring_structure_report(points: np.ndarray, config: ProjectionConfig,
                          row_of_ring: Sequence[int]) -> dict:
    """Host-side contract check for (B, R, P, 3|4) input. Returns a dict
    with ``ok`` plus the violation counts. Copied from JAX
    ``ring_path.ring_structure_report`` (ring_path.py:353)."""
    finite, xs, ys, zs = _finite_xyz(np.asarray(points))
    rng = np.sqrt(np.clip(xs * xs, 0, 1e10) + np.clip(ys * ys, 0, 1e10)
                  + np.clip(zs * zs, 0, 1e10))
    valid = finite & (rng >= config.min_range) & (rng <= config.max_range)
    az = np.mod(np.arctan2(ys, xs) + np.pi, 2 * np.pi)
    azb = np.clip(np.floor(az / (2 * np.pi) * config.n_azimuth), 0,
                  config.n_azimuth - 1).astype(np.int64)
    elev = _elevation_np(xs, ys, zs)
    valid = _elev_gate_np(valid, elev, config)
    span = config.elevation_max - config.elevation_min
    eb = np.clip(np.floor((elev - config.elevation_min) / span
                          * config.n_elevation), 0,
                 config.n_elevation - 1).astype(np.int64)

    rows = np.asarray(row_of_ring, np.int64)
    off_row = int((valid & (eb != rows[None, :, None])).sum())

    max_folds = 1
    b, R, P = valid.shape
    for bi in range(b):
        for r in range(R):
            seq = azb[bi, r][valid[bi, r]]
            if len(seq) < 2:
                continue
            runs = seq[np.concatenate([[True], seq[1:] != seq[:-1]])]
            noninc = int(np.sum(runs[1:] <= runs[:-1]))
            max_folds = max(max_folds, 1 + noninc)
    return {
        "ok": off_row == 0 and np.all(np.diff(rows) > 0),
        "off_row_points": off_row,
        "rows_strictly_increasing": bool(np.all(np.diff(rows) > 0)),
        "max_folds_needed": max_folds,
    }


def points_to_rings(points: np.ndarray, ring_ids: np.ndarray,
                    n_rings: Optional[int] = None,
                    per_ring: Optional[int] = None) -> np.ndarray:
    """Bucket a flat (N, 3|4) cloud into ring-major (R, P, 4) layout,
    keeping each ring's sensor order; rings shorter than P are padded
    with NaN. Copied from JAX ``ring_path.points_to_rings``
    (ring_path.py:526)."""
    pts = np.asarray(points, np.float32)
    if pts.shape[1] == 3:
        pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
    rid = np.asarray(ring_ids).astype(np.int64)
    R = int(n_rings if n_rings is not None else rid.max() + 1)
    counts = np.bincount(rid, minlength=R)
    P = int(per_ring if per_ring is not None else counts.max())
    out = np.full((R, P, 4), np.nan, np.float32)
    # stable per-ring order == original sensor order
    order = np.argsort(rid, kind="stable")
    starts = np.zeros(R + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    for r in range(R):
        seg = order[starts[r]:starts[r + 1]][:P]
        out[r, :len(seg)] = pts[seg]
    return out


def infer_ring_ids_from_sweep(points: np.ndarray,
                              min_ring_gap_rad: float = 2e-3
                              ) -> np.ndarray:
    """Per-point ring ids of a ring-major flat stream without a ring field
    (KITTI .bin order): a new ring starts where the elevation angle jumps
    by more than ``min_ring_gap_rad``; invalid points inherit the current
    ring. Copied from JAX ``ring_path.infer_ring_ids_from_sweep``
    (ring_path.py:552)."""
    finite, xs, ys, zs = _finite_xyz(np.asarray(points))
    elev = _elevation_np(xs, ys, zs)
    # forward-fill invalid elevations so holes never fake a boundary
    idx = np.where(finite, np.arange(len(finite)), -1)
    np.maximum.accumulate(idx, out=idx)
    filled = np.where(idx >= 0, elev[np.maximum(idx, 0)], elev)
    jump = np.abs(np.diff(filled)) > min_ring_gap_rad
    return np.concatenate([[0], np.cumsum(jump)]).astype(np.int64)


def infer_ring_ids_by_elevation(points: np.ndarray,
                                min_ring_gap_rad: float = 2e-3,
                                max_rings: int = 128
                                ) -> Optional[np.ndarray]:
    """Ring ids of a firing-interleaved stream (NCLT's HDL-32E order):
    the sorted elevations cluster into bands separated by more than
    ``min_ring_gap_rad``; ring id = band index, bottom-up. None when the
    elevations do not separate into at most ``max_rings`` bands.
    Invalid points inherit the previous point's ring. Copied from JAX
    ``ring_path.infer_ring_ids_by_elevation`` (ring_path.py:587)."""
    finite, xs, ys, zs = _finite_xyz(np.asarray(points))
    if not finite.any():
        return None
    elev = _elevation_np(xs, ys, zs)
    ev = np.sort(elev[finite])
    boundaries = ev[:-1][np.diff(ev) > min_ring_gap_rad]  # cluster tops
    if len(boundaries) + 1 > max_rings:
        return None
    # side="left": a point exactly AT a cluster's top elevation belongs
    # to that (lower) cluster, not the next one
    rid = np.searchsorted(boundaries, elev, side="left").astype(np.int64)
    idx = np.where(finite, np.arange(len(finite)), -1)
    np.maximum.accumulate(idx, out=idx)
    return rid[np.maximum(idx, 0)]


def infer_row_of_ring(rings: np.ndarray,
                      config: ProjectionConfig) -> np.ndarray:
    """Per-ring dominant elevation row (the mode over its valid points),
    −1 for a ring with no valid point. Copied from JAX
    ``ring_path.infer_row_of_ring`` (ring_path.py:631)."""
    finite, xs, ys, zs = _finite_xyz(rings)
    rng = np.sqrt(np.clip(xs * xs, 0, 1e10) + np.clip(ys * ys, 0, 1e10)
                  + np.clip(zs * zs, 0, 1e10))
    valid = finite & (rng >= config.min_range) & (rng <= config.max_range)
    elev = _elevation_np(xs, ys, zs)
    # drop mode: an entirely out-of-band ring must report row -1
    # (dropped), not vote itself into a clipped boundary row
    valid = _elev_gate_np(valid, elev, config)
    span = config.elevation_max - config.elevation_min
    eb = np.clip(np.floor((elev - config.elevation_min) / span
                          * config.n_elevation), 0,
                 config.n_elevation - 1).astype(np.int64)
    rows = np.zeros(rings.shape[0], np.int64)
    for r in range(rings.shape[0]):
        v = eb[r][valid[r]]
        rows[r] = np.bincount(v, minlength=config.n_elevation).argmax() \
            if len(v) else -1
    return rows


def prepare_structured(points: np.ndarray, ring_ids: np.ndarray, config,
                       per_ring: Optional[int] = None):
    """Host half of :func:`encode_structured`: bucket a flat cloud into
    ring-major layout and check the structure contract (C1-C3, at most
    one wrap event per ring, no point lost to the ring capacity).
    Returns ``(rings, rows)``, a NaN-padded 128-aligned (R, Ppad, 4)
    array and the strictly increasing row tuple, when the ring path
    applies, else None. JAX ``ring_path.prepare_structured``
    (ring_path.py:662) without the TPU stage bounds."""
    proj = config.projection
    rings = points_to_rings(points, ring_ids, per_ring=per_ring)
    n_rings_bucketed, ring_capacity = rings.shape[0], rings.shape[1]
    rows = infer_row_of_ring(rings, proj)
    # row -1 = a ring with no valid point: it adds nothing to the image
    # on either path, so dropping it whole is exact
    keep = rows >= 0
    rings, rows = rings[keep], rows[keep]
    order = np.argsort(rows, kind="stable")
    rings, rows = rings[order], rows[order]
    ok = len(rows) > 0 and np.all(np.diff(rows) > 0)
    if ok:
        rep = ring_structure_report(rings[None], proj, rows)
        ok = rep["ok"] and rep["max_folds_needed"] <= 2
        # points dropped by a short per_ring would change the image; the
        # capacity check uses the shape before dropped rings went
        ok = ok and n_rings_bucketed * ring_capacity >= len(points)
        counts = np.bincount(np.asarray(ring_ids).astype(np.int64))
        ok = ok and counts.max() <= ring_capacity
    if not ok:
        return None
    pp = -(-rings.shape[1] // 128) * 128
    if pp != rings.shape[1]:
        rings = np.pad(rings, ((0, 0), (0, pp - rings.shape[1]), (0, 0)),
                       constant_values=np.nan)
    return rings, tuple(int(r) for r in rows)


def encode_structured(points: np.ndarray, ring_ids: np.ndarray, alpha,
                      config, per_ring: Optional[int] = None,
                      device: DeviceLike = "cuda") -> torch.Tensor:
    """Encode ONE flat (N, 3|4) host cloud with per-point ring ids into
    its (output_dim,) descriptor on ``device``: the ring path when the
    cloud meets the structure contract (:func:`prepare_structured`), else
    the general path on the cloud NaN-padded to a power of two (at least
    64). Either way the descriptor equals ``encode_points_batch`` on the
    flat cloud; on a CUDA device both branches run the kernels. JAX
    ``ring_path.encode_structured`` (ring_path.py:703)."""
    from neural_spectral_codec_torch.ops.spectral import encode_points_batch
    dev = resolve_device(device)
    prep = prepare_structured(points, ring_ids, config, per_ring=per_ring)
    if prep is not None:
        rings, rows = prep
        return encode_points_ring_batch(
            torch.from_numpy(rings[None]).to(dev), alpha, config, rows)[0]
    n_pad = 1 << int(np.ceil(np.log2(max(len(points), 64))))
    padded = pad_points(np.asarray(points), n_pad)
    return encode_points_batch(torch.from_numpy(padded[None]).to(dev),
                               alpha, config)[0]


def make_structured_ring_scans(batch: int, n_rings: int, per_ring: int,
                               config: ProjectionConfig, seed: int = 0,
                               dropout: float = 0.08) -> np.ndarray:
    """Synthetic ring-major scans satisfying C1-C3: each ring sweeps a
    cone at its elevation-bin center with uniformly increasing azimuth
    from a random start angle, random ranges, NaN dropout. Copied from
    JAX ``ring_path.make_structured_ring_scans`` (ring_path.py:727)."""
    rng = np.random.default_rng(seed)
    el = ring_elevation_centers(config, n_rings)                # (R,)
    phi0 = rng.uniform(0, 2 * np.pi, (batch, n_rings, 1))
    az = phi0 + (np.arange(per_ring) / per_ring * 2 * np.pi)[None, None, :]
    r = rng.uniform(2.0, 70.0, (batch, n_rings, per_ring))
    ce, se = np.cos(el)[None, :, None], np.sin(el)[None, :, None]
    pts = np.stack([r * ce * np.cos(az), r * ce * np.sin(az),
                    r * se * np.ones_like(az),
                    rng.uniform(0, 1, r.shape)], axis=-1).astype(np.float32)
    drop = rng.random(r.shape) < dropout
    pts[drop] = np.nan
    return pts
