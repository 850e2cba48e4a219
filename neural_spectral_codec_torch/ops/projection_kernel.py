"""Binding of the general-projection kernel, ``csrc/project.cu``.

It replaces the TPU kernels ``pallas_compact._compact_kernel`` and
``pallas_densify._kernel`` together with the packed-key sort before them.
Its plain PyTorch version is ``range_image.project_points_batch_plain``;
``range_image.project_points_batch`` chooses between the two by device.

A call enqueues the kernel and nothing else: the kernel writes every pixel
of an image allocated with ``torch.empty``; the tables of bin edges it
reads (``edge_tables``) and the scratch images and control words it
merges through (``scratch_for``, left by the kernel as it found them) are
cached on the device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from neural_spectral_codec_torch._build import CudaKernel, check_contiguous
from neural_spectral_codec_torch.ops.range_image import (
    ProjectionConfig, azimuth_bins, check_points, elevation_bins)

KERNEL = CudaKernel("nsc_project_points", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p])

INF_BITS = 0x7F800000  # +inf as float32 bits
MAX_CHUNK = 1024       # points a CTA takes at a time (csrc/project.cu)
CONTROL_WORDS = 96     # arrivals, generation, next chunk: 128 B apart


class LaunchPlan(NamedTuple):
    """How one call cuts its points: ``chunks`` chunks of ``per_chunk``
    points per scan, which the CTAs take in turn; ``n_quads`` 16-byte
    words per scan image."""

    chunks: int
    per_chunk: int
    n_quads: int


def launch_plan(batch: int, n_points: int, n_pix: int) -> LaunchPlan:
    """Chunks of 512 points at B = 1, where a full-density scan then gives
    every CTA of the card about one (261 chunks for 264 CTAs), and of 1024
    at larger batches, where fewer and longer chunks won (PERF.md, K3)."""
    per_chunk = max(1, min(512 if batch == 1 else MAX_CHUNK, n_points))
    return LaunchPlan(-(-n_points // per_chunk), per_chunk, -(-n_pix // 4))


# unbounded: a captured CUDA graph (models/serving.py) keeps reading
# the tensor, so it must never be evicted
@functools.lru_cache(maxsize=None)
def scratch_for(device: torch.device, stream: int, batch: int,
                n_quads: int) -> tuple:
    """(scratch (B, 4·n_quads) int32 at +inf bits, control words
    (CONTROL_WORDS,) int32 at 0) for calls on ``stream`` of ``device``:
    the kernel leaves both as it found them, so one pair serves every call
    of that shape on that stream."""
    scratch = torch.full((batch, 4 * n_quads), INF_BITS, dtype=torch.int32,
                         device=device)
    return scratch, torch.zeros(CONTROL_WORDS, dtype=torch.int32,
                                device=device)


def _keys(f: np.ndarray) -> np.ndarray:
    """float32 → int64 keys in the floats' order (−0 and +0 share 0)."""
    i = np.asarray(f, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _floats(k: np.ndarray) -> np.ndarray:
    """Inverse of ``_keys``."""
    k = np.asarray(k, np.int64)
    bits = np.where(k < 0, (-k) | 0x80000000, k).astype(np.uint32)
    return bits.view(np.float32)


def _first_at_least(level_of, lo: float, hi: float,
                    levels: np.ndarray) -> np.ndarray:
    """For each level k, the least float32 t in [lo, hi] with
    level_of(t) >= k, by bisection over the floats' order; level_of must
    be nondecreasing on [lo, hi] and reach every k by hi."""
    a = np.full(len(levels), _keys(np.float32(lo)), np.int64)
    b = np.full(len(levels), _keys(np.float32(hi)), np.int64)
    while np.any(a < b):
        mid = (a + b) // 2
        up = level_of(torch.from_numpy(_floats(mid))).numpy() >= levels
        b = np.where(up & (a < b), mid, b)
        a = np.where(up | (a >= b), a, mid + 1)
    if np.any(level_of(torch.from_numpy(_floats(a))).numpy() < levels):
        raise ValueError("a level is not reached in the range searched")
    return _floats(a)


def _azimuth_bin(theta: torch.Tensor, n_azim: int) -> torch.Tensor:
    # the plain version's azimuth bin of a float32 angle (range_image.py)
    return azimuth_bins(torch.remainder(theta + math.pi, 2.0 * math.pi),
                        n_azim)


def azimuth_edges(n_azim: int) -> np.ndarray:
    """The float32 angles at which the plain version's azimuth bin steps:
    entry k−1 (k = 1..A−1) is the least angle in bin ≥ k; entry A−1 is
    the least positive angle whose bin wraps to 0 (angle + π rounds to
    2π). Between them the bin is nondecreasing in the rounded angle."""
    pi32 = float(np.float32(math.pi))

    def wraps(t):
        return (_azimuth_bin(t, n_azim) == 0).to(torch.int64)

    wrap = _first_at_least(wraps, 1.0, pi32, np.ones(1, np.int64))
    below = float(_floats(_keys(wrap) - 1)[0])
    steps = _first_at_least(lambda t: _azimuth_bin(t, n_azim), -pi32, below,
                            np.arange(1, n_azim))
    return np.concatenate([steps, wrap])


def elevation_edges(config: ProjectionConfig) -> np.ndarray:
    """The float32 elevations at which the plain version's elevation level
    steps: clip mode, bins 1..E−1 (the level is the bin); drop mode, also
    the band's gates first and last (level 0 and E+1 are dropped, level
    l keeps bin l−1)."""
    half_pi = float(np.float32(math.pi / 2))
    steps = _first_at_least(lambda e: elevation_bins(e, config), -half_pi,
                            half_pi, np.arange(1, config.n_elevation))
    if config.elevation_mode == "drop":
        lo = np.float32(config.elevation_min)
        hi = _floats(_keys(np.float32(config.elevation_max)) + 1)
        steps = np.concatenate([[lo], steps, [hi]]).astype(np.float32)
    if np.any(np.diff(_keys(steps)) <= 0):
        raise ValueError("elevation bins do not step inside the band")
    return steps


def edge_table(edges: np.ndarray) -> np.ndarray:
    """(K, 4) float32 (cos m hi, lo, sin m hi, lo) of each edge's lower
    rounding boundary m, the midpoint between the float32 edge and the
    float before it (exact in float64): an angle rounds to at least the
    edge iff its float64 value lies above m. hi is the float32 nearest
    the float64 cosine or sine and lo the float32 nearest the rest."""
    mid = (_floats(_keys(edges) - 1).astype(np.float64)
           + edges.astype(np.float64)) / 2.0
    out = []
    for f in (np.cos(mid), np.sin(mid)):
        hi = f.astype(np.float32)
        out += [hi, (f - hi.astype(np.float64)).astype(np.float32)]
    return np.stack(out, axis=1)


# unbounded: a captured CUDA graph (models/serving.py) keeps reading
# the tensor, so it must never be evicted
@functools.lru_cache(maxsize=None)
def edge_tables(config: ProjectionConfig, device: torch.device) -> tuple:
    """(azimuth, elevation) edge tables as float32 tensors on ``device``,
    one pair per (config, device)."""
    return tuple(torch.from_numpy(edge_table(e)).to(device) for e in (
        azimuth_edges(config.n_azimuth), elevation_edges(config)))


def geometry_args(config: ProjectionConfig) -> tuple:
    """The kernels' geometry arguments: (min_range, max_range, el_min,
    el_max, span, drop), each float rounded once from its Python double,
    as PyTorch and JAX round a Python scalar."""
    if config.elevation_mode not in ("clip", "drop"):
        raise ValueError(f"unknown elevation_mode {config.elevation_mode!r}")
    if not config.min_range >= 0.0:
        # atomicMin on float bits orders values only for non-negative floats
        raise ValueError("the CUDA projection kernels need min_range >= 0")
    return (config.min_range, config.max_range, config.elevation_min,
            config.elevation_max, config.elevation_span,
            int(config.elevation_mode == "drop"))


def project_points_cuda(points: torch.Tensor,
                        config: ProjectionConfig) -> torch.Tensor:
    """Launch the projection kernel: (B, N, 3|4) float32 CUDA points →
    (B, n_elevation, n_azimuth) float32 images (0 = empty pixel)."""
    check_points(points, 3, "project_points_cuda")
    if points.device.type != "cuda":
        raise ValueError(f"project_points_cuda needs a CUDA tensor, got "
                         f"{points.device}")
    check_contiguous(points, "project_points_cuda")
    b, n, c = points.shape
    if n >= 2 ** 31:
        raise ValueError("project_points_cuda: 2^31 or more points a scan")
    geometry = geometry_args(config)
    img = torch.empty((b, config.n_elevation, config.n_azimuth),
                      dtype=torch.float32, device=points.device)
    if b == 0:
        return img
    plan = launch_plan(b, n, config.n_elevation * config.n_azimuth)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    scratch, control = scratch_for(points.device, stream, b, plan.n_quads)
    az, el = edge_tables(config, points.device)
    with torch.cuda.device(points.device):
        KERNEL(points.data_ptr(), img.data_ptr(), scratch.data_ptr(),
               control.data_ptr(), az.data_ptr(), el.data_ptr(), el.shape[0],
               b, n, c, *plan, config.n_elevation, config.n_azimuth,
               *geometry, stream)
    return img
