"""Binding of the general-projection kernel, ``csrc/project.cu``.

It replaces the TPU kernels ``pallas_compact._compact_kernel`` and
``pallas_densify._kernel`` together with the packed-key sort before them.
Its plain PyTorch version is ``range_image.project_points_batch_plain``;
``range_image.project_points_batch`` chooses between the two by device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from neural_spectral_codec_torch._build import CudaKernel, check_contiguous
from neural_spectral_codec_torch.ops.range_image import (
    ProjectionConfig, check_points)

KERNEL = CudaKernel("nsc_project_points", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p])


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
    if b > 65535:
        raise ValueError("project_points_cuda: batch > 65535")
    img = torch.full((b, config.n_elevation, config.n_azimuth), math.inf,
                     dtype=torch.float32, device=points.device)
    if b == 0:
        return img
    with torch.cuda.device(points.device):
        KERNEL(points.data_ptr(), img.data_ptr(), b, n, c,
               config.n_elevation, config.n_azimuth, *geometry_args(config),
               torch.cuda.current_stream(points.device).cuda_stream)
    return img
