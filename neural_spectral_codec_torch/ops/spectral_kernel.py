"""Binding of the fused spectral-encoder kernel, ``csrc/spectral.cu``.

It replaces the TPU kernel ``pallas_spectral._kernel`` (wrapper
``encode_range_image_batch_pallas``). Its plain PyTorch version is
``spectral.encode_images_plain``; ``spectral.encode_images`` chooses
between the two by device.

The kernel runs a cluster of ``CLUSTER`` CTAs per scan. What it reads
besides the images is made here once and cached on the device: the
A-entry (cos, sin) table (``twiddle_table``) and the frequency range of
each bin (``bin_bounds``). For a Python-float α a call therefore enqueues
the output allocation and the kernel and nothing else; a tensor α (a
differentiable one, in training) computes its ranges on every call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch._build import (
    MAX_SHARED_BYTES, CudaKernel, check_contiguous)
from neural_spectral_codec_torch.ops.spectral import (
    Alpha, SpectralEncoderConfig, bin_assignment)

KERNEL = CudaKernel("nsc_spectral_encode", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p])

MAX_AZIMUTH = 384                 # 12 warp-wide column chunks per row
CLUSTER = 8                       # kCluster: CTAs per scan
_WARPS = 24                       # kWarps: 768 threads
_SEGMENTS = 4                     # kSegments: column segments of the DFT


def cta_rows(n_elev: int, n_target: int,
             cluster: int = CLUSTER) -> List[Tuple[int, int, int, int]]:
    """Per CTA of a scan's cluster, ``(t_lo, t_hi, in_lo, in_hi)``: the
    pooled rows [t_lo, t_hi) it owns and the input rows [in_lo, in_hi)
    their pooling windows read (``spectral.pooling_matrix``: row t
    averages [floor(t·E/T), ceil((t+1)·E/T))). Mirrors the kernel."""
    out = []
    for rank in range(cluster):
        t_lo = rank * n_target // cluster
        t_hi = (rank + 1) * n_target // cluster
        if t_hi > t_lo:
            in_lo = t_lo * n_elev // n_target
            in_hi = -(-t_hi * n_elev // n_target)
        else:
            in_lo = in_hi = 0
        out.append((t_lo, t_hi, in_lo, in_hi))
    return out


def twiddle_table(n_azim: int) -> np.ndarray:
    """(n_azim, 2) float32 ``(cos, sin)(2π·m / A)``, rounded once from
    float64: entry ``(a·k) mod A`` stands for ``spectral.dft_bases``'s
    ``[a, k]``."""
    ang = 2.0 * np.pi * np.arange(n_azim) / n_azim
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def bin_bounds(assign: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(n_bins + 1,) int32: bin b holds the frequencies [bounds[b],
    bounds[b+1]) of a non-decreasing (n_freqs,) bin assignment (an empty
    bin has an empty range)."""
    levels = torch.arange(n_bins + 1, dtype=assign.dtype, device=assign.device)
    return torch.searchsorted(assign, levels).to(torch.int32)


# unbounded: a captured CUDA graph (models/serving.py) keeps reading
# the tensor, so it must never be evicted
@functools.lru_cache(maxsize=None)
def _twiddle(n_azim: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(twiddle_table(n_azim)).to(device)


# unbounded: a captured CUDA graph (models/serving.py) keeps reading
# the tensor, so it must never be evicted
@functools.lru_cache(maxsize=None)
def _bounds(alpha: float, n_bins: int, n_freqs: int, epsilon: float,
            device: torch.device) -> torch.Tensor:
    assign = bin_assignment(alpha, n_bins, n_freqs, epsilon, device)
    if bool((assign[1:] < assign[:-1]).any()):
        raise ValueError(f"alpha {alpha}: the bin assignment is not "
                         "monotone, so bins are not frequency ranges")
    return bin_bounds(assign, n_bins)


def bounds_for(alpha: Alpha, config: SpectralEncoderConfig,
               device: torch.device) -> torch.Tensor:
    """The bin ranges the kernel reads: cached for a Python-float α,
    computed on ``device`` for a tensor α."""
    if torch.is_tensor(alpha):
        return bin_bounds(bin_assignment(alpha, config.n_bins, config.n_freqs,
                                         config.epsilon, device),
                          config.n_bins)
    return _bounds(float(alpha), config.n_bins, config.n_freqs,
                   config.epsilon, device)


def shared_bytes(n_elev: int, n_azim: int, n_target: int, n_bins: int) -> int:
    """Dynamic shared memory of one CTA (mirrors ``smem_bytes`` in the
    kernel source)."""
    n_freqs = n_azim // 2 + 1
    max_in, max_t = _cta_maxima(n_elev, n_target)
    max_pairs = (max_t + 1) // 2
    return (8 * (n_azim + n_azim // 16 + 1 + _SEGMENTS * max_t * n_freqs
                 + max_pairs * n_azim)
            + 16 * max_pairs * ((n_azim - 1) // 2)
            + 4 * (max_in * n_azim + max_t * n_freqs + max_t * n_bins
                   + _WARPS + CLUSTER)
            + 4 * (n_bins + 1 + n_elev))


@functools.lru_cache(maxsize=64)
def _cta_maxima(n_elev: int, n_target: int) -> Tuple[int, int]:
    rows = cta_rows(n_elev, n_target)
    return (max(hi - lo for _, _, lo, hi in rows),
            max(hi - lo for lo, hi, _, _ in rows))


def encode_images_cuda(imgs: torch.Tensor, alpha: Alpha,
                       config: SpectralEncoderConfig) -> torch.Tensor:
    """Launch the fused kernel: (B, E, A) float32 CUDA images →
    (B, target·n_bins) descriptors."""
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
    bounds = bounds_for(alpha, config, imgs.device)
    twiddle = _twiddle(n_azim, imgs.device)
    max_in, max_t = _cta_maxima(n_elev, n_target)
    with torch.cuda.device(imgs.device):
        KERNEL(imgs.data_ptr(), bounds.data_ptr(), twiddle.data_ptr(),
               out.data_ptr(), b, n_elev, n_azim, n_target, n_bins,
               config.n_freqs, max_in, max_t, config.epsilon,
               int(config.interpolate_empty),
               torch.cuda.current_stream(imgs.device).cuda_stream)
    return out
