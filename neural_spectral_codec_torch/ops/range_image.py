"""Panoramic range-image projection and empty-pixel interpolation.

Port of ``neural_spectral_codec_tpu/ops/range_image.py``. On the GPU the
per-pixel min over arbitrary-order points is one pass of atomics
(``csrc/project.cu``), so the TPU's packed-key sort and compaction and
expansion butterflies have no counterpart here. The plain PyTorch version
is a ``scatter_reduce_(..., "amin")`` into a +inf buffer.

Numerics follow the JAX reference operation for operation (same order, a
float32 rounding after each step), with one deliberate difference: the
two angles and the two square roots are computed in float64 and rounded
once to float32. Float32 ``atan2`` differs in the last ulp between
libraries (CPU PyTorch, XLA, CUDA), and a 1-ulp difference moves a point
near a bin edge into the next pixel; at full density that moved CPU and
card descriptors apart by more than 1e-4. PyTorch's vectorised CPU
``sqrt`` is not always correctly rounded either (on an H100 host 0.56% of
ranges came out 1 ulp off the card's). Rounded from float64, angle and
root are the correctly rounded ones on every device, so the CPU path and
the CUDA kernels give the same image.
Divisions by a constant go through a device tensor, not a Python scalar:
PyTorch's CUDA division by a CPU scalar multiplies by the reciprocal,
which rounds differently.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device

_BIG = 1 << 20  # distance sentinel for "no valid pixel found"


class ProjectionConfig(NamedTuple):
    """Static projection geometry (JAX ``range_image.ProjectionConfig``).

    ``elevation_mode``: ``"clip"`` puts out-of-band elevations in the
    boundary rows; ``"drop"`` discards them."""

    n_elevation: int = 64
    n_azimuth: int = 360
    elevation_range_deg: Tuple[float, float] = (-24.8, 2.0)
    max_range: float = 80.0
    min_range: float = 1.0
    elevation_mode: str = "clip"

    @property
    def elevation_min(self) -> float:
        return math.radians(self.elevation_range_deg[0])

    @property
    def elevation_max(self) -> float:
        return math.radians(self.elevation_range_deg[1])

    @property
    def elevation_span(self) -> float:
        return self.elevation_max - self.elevation_min


@functools.lru_cache(maxsize=None)
def _constant(c: float, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    # a 0-d tensor made once per (value, type, device), never copied from
    # the host per call (such a copy cannot be captured into a CUDA graph)
    return torch.tensor(c, dtype=dtype, device=device)


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` with an IEEE float32 division on every device (see the
    module docstring): a division by a tensor, which PyTorch's CUDA
    kernels do not turn into a product with the reciprocal."""
    return x / _constant(float(c), x.dtype, x.device)


def atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2 computed in float64 and rounded once (see the module
    docstring; ``csrc/common.cuh`` does the same)."""
    return torch.atan2(y.double(), x.double()).float()


def sqrt_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 sqrt computed in float64 and rounded once, which is the
    correctly rounded result (53 ≥ 2·24 + 2 bits), as ``__fsqrt_rn`` in
    ``csrc/common.cuh`` gives it."""
    return torch.sqrt(v.double()).float()


def _spherical(points: torch.Tensor):
    """xyz → (range, azimuth in [0, 2π), elevation, finite), as JAX's
    ``_spherical`` (range_image.py:61-80). Non-finite rows get safe
    stand-in coordinates and a False finiteness flag."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    finite = torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)
    x = torch.where(finite, x, 1.0)
    y = torch.where(finite, y, 0.0)
    z = torch.where(finite, z, 0.0)
    x_sq = torch.clamp(x * x, 0.0, 1e10)
    y_sq = torch.clamp(y * y, 0.0, 1e10)
    z_sq = torch.clamp(z * z, 0.0, 1e10)
    xy_sq = x_sq + y_sq
    rng = sqrt_f32(xy_sq + z_sq)
    azimuth = torch.remainder(atan2_f32(y, x) + math.pi, 2.0 * math.pi)
    elevation = atan2_f32(z, sqrt_f32(xy_sq))
    return rng, azimuth, elevation, finite


def _valid_mask(rng, elevation, finite, config: ProjectionConfig):
    """Range gates + (drop mode only) the elevation-band gate."""
    valid = finite & (rng >= config.min_range) & (rng <= config.max_range)
    if config.elevation_mode == "drop":
        valid = valid & (elevation >= config.elevation_min) \
            & (elevation <= config.elevation_max)
    return valid


def azimuth_bins(azimuth: torch.Tensor, n_azimuth: int) -> torch.Tensor:
    """floor(az / 2π · A), clipped to [0, A−1], int64."""
    b = torch.floor(div_const(azimuth, 2.0 * math.pi) * n_azimuth)
    return torch.clamp(b.to(torch.int64), 0, n_azimuth - 1)


def elevation_bins(elevation: torch.Tensor,
                   config: ProjectionConfig) -> torch.Tensor:
    """floor((el − el_min) / span · E), clipped to [0, E−1], int64."""
    v = div_const(elevation - config.elevation_min, config.elevation_span)
    b = torch.floor(v * config.n_elevation)
    return torch.clamp(b.to(torch.int64), 0, config.n_elevation - 1)


def check_points(points: torch.Tensor, ndim: int, what: str) -> None:
    if points.dim() != ndim or points.shape[-1] not in (3, 4):
        raise ValueError(f"{what}: expected {ndim}-D points with 3 or 4 "
                         f"channels, got shape {tuple(points.shape)}")
    if points.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32 points, got {points.dtype}")


def project_points_batch_plain(points: torch.Tensor,
                               config: ProjectionConfig) -> torch.Tensor:
    """Plain PyTorch version of the general projection: (B, N, 3|4) →
    (B, n_elevation, n_azimuth), the min range per pixel (0 = empty).
    Semantics of JAX ``project_points`` (range_image.py:93-130,
    ``np.minimum.at``), computed as one ``scatter_reduce_("amin")``."""
    check_points(points, 3, "project_points_batch")
    b = points.shape[0]
    n_pix = config.n_elevation * config.n_azimuth
    rng, azimuth, elevation, finite = _spherical(points)
    valid = _valid_mask(rng, elevation, finite, config)
    pix = elevation_bins(elevation, config) * config.n_azimuth \
        + azimuth_bins(azimuth, config.n_azimuth)
    base = torch.arange(b, device=points.device)[:, None] * n_pix
    target = torch.where(valid, pix + base, b * n_pix)   # dump slot
    vals = torch.where(valid, rng, math.inf)
    buf = torch.full((b * n_pix + 1,), math.inf, dtype=torch.float32,
                     device=points.device)
    buf.scatter_reduce_(0, target.reshape(-1), vals.reshape(-1), "amin")
    img = buf[:-1].reshape(b, config.n_elevation, config.n_azimuth)
    return torch.where(torch.isinf(img), 0.0, img)


def project_points_batch(points: torch.Tensor,
                         config: ProjectionConfig) -> torch.Tensor:
    """(B, N, 3|4) float32 points → (B, n_elevation, n_azimuth) range
    images. A CPU tensor takes the plain version; a CUDA tensor launches
    the hand-written kernel (``ops/projection_kernel.py``) and any other
    device raises."""
    if points.device.type == "cpu":
        return project_points_batch_plain(points, config)
    from neural_spectral_codec_torch.ops.projection_kernel import (
        project_points_cuda)
    return project_points_cuda(points, config)


def project_points(points: torch.Tensor,
                   config: ProjectionConfig) -> torch.Tensor:
    """One padded (N, 3|4) float32 cloud → (n_elevation, n_azimuth) range
    image, 0 = empty (JAX ``project_points``, range_image.py:93): a
    one-scan batch of ``project_points_batch``, so a CUDA tensor goes
    through the projection kernel."""
    check_points(points, 2, "project_points")
    return project_points_batch(points[None], config)[0]


def _nearest_valid(val: torch.Tensor, d: torch.Tensor, dim: int,
                   n: int, direction: int, circular: bool):
    """Pointer doubling along ``dim``: for every slot, the value and
    distance of the nearest slot with d == 0 in ``direction`` (+1 = from
    lower indices). Non-circular shifts treat the edge as _BIG away."""
    shape = [1] * val.dim()
    shape[dim] = n
    idx = torch.arange(n, device=val.device).reshape(shape)
    shift = 1
    while shift < n:
        sv = torch.roll(val, direction * shift, dims=dim)
        sd = torch.roll(d, direction * shift, dims=dim) + shift
        if not circular:
            inside = idx >= shift if direction > 0 else idx < n - shift
            sd = torch.where(inside, sd, _BIG)
        take = sd < d
        val = torch.where(take, sv, val)
        d = torch.minimum(d, sd)
        shift *= 2
    return val, d


def _fill_empty_rows(img: torch.Tensor,
                     row_nonempty: torch.Tensor) -> torch.Tensor:
    """(B, E, A) images: an empty row takes the nearest originally
    non-empty row above it, else the nearest below (JAX
    ``_fill_empty_rows``, range_image.py:477-514). Scans with no
    non-empty row stay as they are."""
    n_rows = img.shape[1]
    d0 = torch.where(row_nonempty, 0, _BIG).to(torch.int32)[..., None]
    d0 = d0.expand_as(img)
    val_a, d_a = _nearest_valid(img, d0, 1, n_rows, 1, circular=False)
    val_b, _ = _nearest_valid(img, d0, 1, n_rows, -1, circular=False)
    filled = torch.where(d_a < _BIG, val_a, val_b)
    out = torch.where(row_nonempty[..., None], img, filled)
    return torch.where(row_nonempty.any(dim=1)[:, None, None], out, img)


def interpolate_range_image(img: torch.Tensor,
                            method: str = "linear") -> torch.Tensor:
    """Circular interpolation of empty (not > 0) pixels per row, then the
    empty-row fill. Accepts (E, A) or (B, E, A). Port of JAX
    ``interpolate_range_image`` (range_image.py:518-574): ``"linear"``
    reproduces the reference's ``np.interp`` over the circularly extended
    valid samples; ``"nearest"`` takes the nearest valid pixel, and on a
    distance tie the one at the smaller absolute column (the reference's
    ``np.argmin`` over ascending valid indices)."""
    if method not in ("linear", "nearest"):
        raise ValueError(f"unknown interpolation method: {method!r}")
    single = img.dim() == 2
    if single:
        img = img[None]
    width = img.shape[-1]
    valid = img > 0.0
    d0 = torch.where(valid, 0, _BIG).to(torch.int32)
    val_l, d_l = _nearest_valid(img, d0, 2, width, 1, circular=True)
    val_r, d_r = _nearest_valid(img, d0, 2, width, -1, circular=True)
    row_has_valid = valid.any(dim=2, keepdim=True)
    if method == "linear":
        dl = d_l.to(img.dtype)
        dr = d_r.to(img.dtype)
        denom = dl + dr
        safe = torch.where(denom > 0, denom, 1.0)
        interp = (val_l * dr + val_r * dl) / safe
        interp = torch.where(denom > 0, interp, val_l)
    else:
        cols = torch.arange(width, dtype=torch.int32, device=img.device)
        idx_l = torch.remainder(cols - d_l, width)
        idx_r = torch.remainder(cols + d_r, width)
        take_left = (d_l < d_r) | ((d_l == d_r) & (idx_l <= idx_r))
        interp = torch.where(take_left, val_l, val_r)
    out = torch.where(valid | ~row_has_valid, img, interp)
    out = _fill_empty_rows(out, row_has_valid[..., 0])
    return out[0] if single else out


def project_points_with_intensity(points: torch.Tensor,
                                  config: ProjectionConfig):
    """(N, 3|4) float32 points → (range image, intensity image), each
    (n_elevation, n_azimuth). A pixel's intensity is the MAX intensity
    among the points whose range equals the pixel's minimum exactly,
    floored at 0; non-finite intensities count as 0 (JAX
    ``project_points_with_intensity``, range_image.py:578, the
    reference's ``np.maximum.at`` over the closest-point mask). Plain
    PyTorch on any device: two ``scatter_reduce_`` passes."""
    check_points(points, 2, "project_points_with_intensity")
    n_pix = config.n_elevation * config.n_azimuth
    rng, azimuth, elevation, finite = _spherical(points)
    valid = _valid_mask(rng, elevation, finite, config)
    intens = points[:, 3] if points.shape[1] > 3 else torch.zeros_like(rng)
    intens = torch.where(valid & torch.isfinite(intens), intens, 0.0)
    pix = elevation_bins(elevation, config) * config.n_azimuth \
        + azimuth_bins(azimuth, config.n_azimuth)
    target = torch.where(valid, pix, n_pix)                # dump slot
    vals = torch.where(valid, rng, math.inf)
    rbuf = torch.full((n_pix + 1,), math.inf, dtype=torch.float32,
                      device=points.device)
    rbuf.scatter_reduce_(0, target, vals, "amin")
    tie = valid & (vals == rbuf[target])
    ibuf = torch.zeros((n_pix + 1,), dtype=torch.float32,
                       device=points.device)
    ibuf.scatter_reduce_(0, torch.where(tie, target, n_pix),
                         torch.where(tie, intens, 0.0), "amax")
    img = rbuf[:-1].reshape(config.n_elevation, config.n_azimuth)
    iimg = ibuf[:-1].reshape(config.n_elevation, config.n_azimuth)
    empty = torch.isinf(img)
    return torch.where(empty, 0.0, img), torch.where(empty, 0.0, iimg)


def unproject_range_image(img: torch.Tensor, config: ProjectionConfig):
    """(E, A) range image → ``(points (E·A, 3), mask (E·A,))``: pixel
    (e, a) at elevation ``el_min + e/E · span`` and azimuth ``a/A · 2π``
    (the reference's grid, range_image.py:234-285), masked rows zeroed
    (JAX ``unproject_range_image``, range_image.py:671)."""
    n_elev, n_azim = img.shape
    rows = torch.arange(n_elev, dtype=torch.float32, device=img.device)
    cols = torch.arange(n_azim, dtype=torch.float32, device=img.device)
    elevation = config.elevation_min \
        + div_const(rows, float(n_elev))[:, None] * config.elevation_span
    azimuth = div_const(cols, float(n_azim))[None, :] * 2.0 * math.pi
    mask = (img > 0.0).reshape(-1)
    x = img * torch.cos(elevation) * torch.cos(azimuth)
    y = img * torch.cos(elevation) * torch.sin(azimuth)
    z = img * torch.sin(elevation) * torch.ones_like(azimuth)
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    return torch.where(mask[:, None], pts, 0.0), mask


def range_image_difference(img1: torch.Tensor, img2: torch.Tensor,
                           threshold: float = 0.5) -> torch.Tensor:
    """Fraction of jointly valid pixels that differ by more than
    ``threshold``; 1.0 when no pixel is valid in both (JAX
    ``range_image_difference``, range_image.py:699)."""
    valid = (img1 > 0) & (img2 > 0)
    n_valid = valid.sum()
    diff_cnt = (valid & ((img1 - img2).abs() > threshold)).sum()
    return torch.where(n_valid > 0, diff_cnt / n_valid.clamp(min=1),
                       torch.ones((), device=img1.device))


def pad_points(points: np.ndarray, max_points: int) -> np.ndarray:
    """Host helper: pad/truncate an (N, 3|4) cloud to (max_points, 4) with
    NaN (copied from JAX ``range_image.pad_points``, range_image.py:710).
    NaN rows fail the finiteness gate, so padding is invisible."""
    out = np.full((max_points, 4), np.nan, dtype=np.float32)
    n = min(len(points), max_points)
    out[:n, : points.shape[1]] = points[:n]
    if points.shape[1] == 3:
        out[:n, 3] = 0.0
    return out


class RangeImageProjector:
    """Numpy-in, numpy-out projector with the reference's surface
    (``project`` / ``unproject``; JAX ``RangeImageProjector``,
    range_image.py:724). Clouds are NaN-padded or cut to ``max_points``
    and run on ``device``."""

    def __init__(self, n_elevation: int = 64, n_azimuth: int = 360,
                 elevation_range: Tuple[float, float] = (-24.8, 2.0),
                 max_range: float = 80.0, min_range: float = 1.0,
                 max_points: int = 131072, device: DeviceLike = "cuda"):
        self.config = ProjectionConfig(
            n_elevation=n_elevation, n_azimuth=n_azimuth,
            elevation_range_deg=tuple(elevation_range),
            max_range=max_range, min_range=min_range)
        self.n_elevation = n_elevation
        self.n_azimuth = n_azimuth
        self.max_points = max_points
        self.device = resolve_device(device)

    def project(self, points: np.ndarray, keep_intensity: bool = False):
        """(N, 3|4) → ``(range_image, intensity_image or None)`` as
        numpy."""
        padded = torch.from_numpy(pad_points(np.asarray(points),
                                             self.max_points)).to(self.device)
        if keep_intensity:
            img, iimg = project_points_with_intensity(padded, self.config)
            return img.cpu().numpy(), iimg.cpu().numpy()
        img = project_points_batch(padded[None], self.config)[0]
        return img.cpu().numpy(), None

    def unproject(self, range_image: np.ndarray) -> np.ndarray:
        """Range image → (N, 3) points of its non-empty pixels."""
        pts, mask = unproject_range_image(
            torch.from_numpy(np.asarray(range_image, np.float32)).to(
                self.device), self.config)
        return pts[mask].cpu().numpy()
