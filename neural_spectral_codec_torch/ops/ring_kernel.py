"""Binding of the ring-projection kernel, ``csrc/ring_fold.cu``.

It replaces the TPU kernel ``pallas_ring._ring_fold_kernel`` fused with
``ring_path._ring_keys``, ``_fold_min`` and the row placement. Its plain
PyTorch version is ``ring_path.project_rings_batch_plain``;
``ring_path.project_rings_batch`` chooses between the two by device.

A call enqueues the image allocation and the kernel and nothing else: the
``row_of_ring`` table is cached on the device (``row_table``) and the
kernel writes every pixel, the rows without a ring included.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from neural_spectral_codec_torch._build import (
    MAX_SHARED_BYTES, CudaKernel, check_contiguous)
from neural_spectral_codec_torch.ops.projection_kernel import geometry_args
from neural_spectral_codec_torch.ops.range_image import (
    ProjectionConfig, check_points)
from neural_spectral_codec_torch.ops.ring_path import check_rows

KERNEL = CudaKernel("nsc_ring_fold", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


# unbounded: a captured CUDA graph (models/serving.py) keeps reading
# the tensor, so it must never be evicted
@functools.lru_cache(maxsize=None)
def row_table(rows: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``row_of_ring`` as an int32 tensor on ``device``, one per (rows,
    device): the kernel reads it, and a cached table spares every call a
    copy from pageable host memory."""
    return torch.tensor(rows, dtype=torch.int32, device=device)


def project_rings_cuda(points: torch.Tensor, config: ProjectionConfig,
                       row_of_ring: Sequence[int],
                       n_folds: int = 2) -> torch.Tensor:
    """Launch the ring kernel: (B, R, P, 3|4) float32 CUDA points →
    (B, n_elevation, n_azimuth) images; rows without a ring are 0."""
    check_points(points, 4, "project_rings_cuda")
    if points.device.type != "cuda":
        raise ValueError(f"project_rings_cuda needs a CUDA tensor, got "
                         f"{points.device}")
    check_contiguous(points, "project_rings_cuda")
    b, n_rings, per_ring, n_chan = points.shape
    rows = check_rows(row_of_ring, n_rings, config)
    if n_folds < 1:
        raise ValueError("n_folds must be >= 1")
    smem = 8 * per_ring + 4 * config.n_azimuth
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"project_rings_cuda: {per_ring} points per ring "
                         f"need {smem} B of shared memory")
    if b == 0 or n_rings == 0:
        return torch.zeros((b, config.n_elevation, config.n_azimuth),
                           dtype=torch.float32, device=points.device)
    img = torch.empty((b, config.n_elevation, config.n_azimuth),
                      dtype=torch.float32, device=points.device)
    rows_t = row_table(rows, points.device)
    with torch.cuda.device(points.device):
        KERNEL(points.data_ptr(), rows_t.data_ptr(), img.data_ptr(), b,
               n_rings, per_ring, n_chan, n_folds, config.n_elevation,
               config.n_azimuth, *geometry_args(config),
               torch.cuda.current_stream(points.device).cuda_stream)
    return img
