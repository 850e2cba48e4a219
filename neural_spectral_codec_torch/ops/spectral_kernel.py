"""Binding of the fused spectral-encoder kernel, ``csrc/spectral.cu``.

It replaces the TPU kernel ``pallas_spectral._kernel`` (wrapper
``encode_range_image_batch_pallas``). Its plain PyTorch version is
``spectral.encode_images_plain``; ``spectral.encode_images`` chooses
between the two by device.
"""

from __future__ import annotations

import ctypes

import torch

from neural_spectral_codec_torch._build import (
    MAX_SHARED_BYTES, CudaKernel, check_contiguous)
from neural_spectral_codec_torch.ops.spectral import (
    Alpha, SpectralEncoderConfig, bin_assignment, dft_bases_tensors)

KERNEL = CudaKernel("nsc_spectral_encode", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p])

MAX_AZIMUTH = 384                 # 12 warp-wide column chunks per row


def shared_bytes(n_elev: int, n_azim: int, n_target: int, n_bins: int) -> int:
    """Dynamic shared memory of one CTA (mirrors ``smem_bytes`` in the
    kernel source)."""
    n_freqs = n_azim // 2 + 1
    return 4 * (n_elev * n_azim + n_target * n_azim + n_target * n_freqs
                + n_target * n_bins + n_freqs + n_elev + 33)


def encode_images_cuda(imgs: torch.Tensor, alpha: Alpha,
                       config: SpectralEncoderConfig) -> torch.Tensor:
    """Launch the fused kernel: (B, E, A) float32 CUDA images →
    (B, target·n_bins) descriptors. The bin of each frequency is computed
    here from ``alpha`` (so α stays a runtime input)."""
    if imgs.device.type != "cuda":
        raise ValueError(f"encode_images_cuda needs a CUDA tensor, got "
                         f"{imgs.device}")
    if imgs.dim() != 3 or imgs.dtype != torch.float32:
        raise ValueError("encode_images_cuda: expected (B, E, A) float32, "
                         f"got {tuple(imgs.shape)} {imgs.dtype}")
    check_contiguous(imgs, "encode_images_cuda")
    b, n_elev, n_azim = imgs.shape
    if n_azim != config.n_azimuth:
        raise ValueError(f"image width {n_azim} != config.n_azimuth "
                         f"{config.n_azimuth}")
    if n_azim > MAX_AZIMUTH:
        raise ValueError(f"encode_images_cuda supports n_azimuth <= "
                         f"{MAX_AZIMUTH}, got {n_azim}")
    n_target, n_bins = config.target_elevation_bins, config.n_bins
    need = shared_bytes(n_elev, n_azim, n_target, n_bins)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"encode_images_cuda: {need} B of shared memory "
                         f"exceeds {MAX_SHARED_BYTES}")
    out = torch.empty((b, n_target * n_bins), dtype=torch.float32,
                      device=imgs.device)
    if b == 0:
        return out
    assign = bin_assignment(alpha, n_bins, config.n_freqs, config.epsilon,
                            imgs.device).to(torch.int32)
    cos_b, sin_b = dft_bases_tensors(n_azim, imgs.device)
    with torch.cuda.device(imgs.device):
        KERNEL(imgs.data_ptr(), assign.data_ptr(), cos_b.data_ptr(),
               sin_b.data_ptr(), out.data_ptr(), b, n_elev, n_azim,
               n_target, n_bins, config.n_freqs,
               config.epsilon, int(config.interpolate_empty),
               torch.cuda.current_stream(imgs.device).cuda_stream)
    return out
