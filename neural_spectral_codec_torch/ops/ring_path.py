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
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.ops.range_image import (
    ProjectionConfig, _spherical, _valid_mask, azimuth_bins, check_points)
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


def ring_rows_plain(points: torch.Tensor, config: ProjectionConfig,
                    n_folds: int = 2) -> torch.Tensor:
    """(B, R, P, 3|4) → (B, R, n_azimuth): each ring's own row, the min
    range of its kept valid points per azimuth bin (0 = empty). This is
    what ``pallas_ring.ring_fold_pallas`` followed by ``_fold_min``
    computes."""
    check_points(points, 4, "ring_rows")
    b, n_rings, per_ring = points.shape[:3]
    vals, key = _ring_keys(points, config)
    valid = key >= 0
    pos = torch.arange(per_ring, device=points.device)
    # index of the last valid point at or before each position
    last = torch.where(valid, pos, -1).cummax(dim=-1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]],
                     dim=-1)
    prev_key = torch.gather(key, -1, prev.clamp(min=0))
    event = valid & (prev >= 0) & (key < prev_key)
    keep = valid & (event.cumsum(dim=-1) <= n_folds - 1)
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


def ring_structure_report(points: np.ndarray, config: ProjectionConfig,
                          row_of_ring: Sequence[int]) -> dict:
    """Host-side contract check for (B, R, P, 3|4) input. Returns a dict
    with ``ok`` plus the violation counts. Copied from JAX
    ``ring_path.ring_structure_report`` (ring_path.py:353)."""
    pts = np.asarray(points)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    finite = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    xs = np.where(finite, x, 1.0)
    ys = np.where(finite, y, 0.0)
    zs = np.where(finite, z, 0.0)
    rng = np.sqrt(np.clip(xs * xs, 0, 1e10) + np.clip(ys * ys, 0, 1e10)
                  + np.clip(zs * zs, 0, 1e10))
    valid = finite & (rng >= config.min_range) & (rng <= config.max_range)
    az = np.mod(np.arctan2(ys, xs) + np.pi, 2 * np.pi)
    azb = np.clip(np.floor(az / (2 * np.pi) * config.n_azimuth), 0,
                  config.n_azimuth - 1).astype(np.int64)
    elev = np.arctan2(zs, np.sqrt(np.clip(xs * xs, 0, 1e10)
                                  + np.clip(ys * ys, 0, 1e10)))
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
