"""Spectral histogram encoder: range image → 800-D descriptor.

Port of ``neural_spectral_codec_tpu/ops/spectral.py``:

    range image (E, A)
      → (optional) circular interpolation + empty-row fill
      → adaptive average pool of the rows to ``target_elevation_bins``
      → unnormalised rFFT magnitudes per row
      → exponential-α frequency binning (searchsorted-right − 1, clipped)
      → flatten + global sum-to-1, uniform fallback for an empty histogram

``encode_images`` is the wrapper of the fused CUDA kernel
(``csrc/spectral.cu``, replacing ``pallas_spectral._kernel``): a CPU
tensor takes the plain version ``encode_images_plain``, a CUDA tensor the
kernel.

The single-scan API (``encode_points``, ``encode_range_image``) and the
class surface of the reference (``SpectralEncoder``: numpy in, numpy out;
``SpectralEncoderNumpy``, the 50-D variant) are one-scan batches of the
batch entry points, so on a card they launch the same kernels.
``SpectralEncoder`` pads or cuts a cloud to ``max_points`` (131,072), as
JAX's does: the last 2,560 points of a full HDL-64E scan (133,632) are
not seen.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.ops.range_image import (
    ProjectionConfig, RangeImageProjector, interpolate_range_image,
    pad_points, project_points_batch)

Alpha = Union[float, torch.Tensor]


class SpectralEncoderConfig(NamedTuple):
    """Static encoder hyperparameters (JAX ``SpectralEncoderConfig``
    without ``use_pallas``: the device of the input picks the route)."""

    n_elevation: int = 64
    n_azimuth: int = 360
    n_bins: int = 50
    target_elevation_bins: int = 16
    alpha: float = 2.0
    epsilon: float = 1e-8
    interpolate_empty: bool = True
    elevation_range_deg: Tuple[float, float] = (-24.8, 2.0)
    max_range: float = 80.0
    min_range: float = 1.0
    elevation_mode: str = "clip"

    @property
    def n_freqs(self) -> int:
        return self.n_azimuth // 2 + 1

    @property
    def output_dim(self) -> int:
        return self.target_elevation_bins * self.n_bins

    @property
    def projection(self) -> ProjectionConfig:
        return ProjectionConfig(
            n_elevation=self.n_elevation,
            n_azimuth=self.n_azimuth,
            elevation_range_deg=self.elevation_range_deg,
            max_range=self.max_range,
            min_range=self.min_range,
            elevation_mode=self.elevation_mode,
        )


def _alpha(alpha: Alpha, device) -> torch.Tensor:
    return torch.as_tensor(alpha, dtype=torch.float32, device=device)


def compute_bin_edges(alpha: Alpha, n_bins: int, n_freqs: int,
                      epsilon: float = 1e-8, device="cpu") -> torch.Tensor:
    """Exponential-warped bin edges, float32 (JAX ``compute_bin_edges``)."""
    a = _alpha(alpha, device)
    t = torch.linspace(0.0, 1.0, n_bins + 1, device=a.device)
    edges = (torch.exp(a * t) - 1.0) / (torch.exp(a) - 1.0 + epsilon)
    return edges * n_freqs


def bin_assignment(alpha: Alpha, n_bins: int, n_freqs: int,
                   epsilon: float = 1e-8, device="cpu") -> torch.Tensor:
    """(n_freqs,) int64 bin of each frequency: searchsorted(edges, f,
    right) − 1, clipped to [0, n_bins − 1]."""
    edges = compute_bin_edges(alpha, n_bins, n_freqs, epsilon, device)
    freqs = torch.arange(n_freqs, dtype=edges.dtype, device=edges.device)
    assign = torch.searchsorted(edges, freqs, right=True) - 1
    return torch.clamp(assign, 0, n_bins - 1)


def binning_matrix(alpha: Alpha, n_bins: int, n_freqs: int,
                   epsilon: float = 1e-8, device="cpu") -> torch.Tensor:
    """(n_freqs, n_bins) float32 one-hot assignment matrix
    (JAX ``binning_matrix``): ``hist = mags @ binning_matrix``. A
    comparison with the bin indices, not ``one_hot``, which reads the
    indices' range back to the host."""
    assign = bin_assignment(alpha, n_bins, n_freqs, epsilon, device)
    bins = torch.arange(n_bins, dtype=assign.dtype, device=assign.device)
    return (assign[:, None] == bins).to(torch.float32)


def pooling_matrix(n_elevation: int, target: int) -> np.ndarray:
    """(target, n_elevation) row-pooling matrix with
    ``adaptive_avg_pool2d`` row semantics: row i averages input rows
    [floor(i·E/T), ceil((i+1)·E/T)). Copied from JAX
    ``spectral.pooling_matrix`` (spectral.py:109)."""
    P = np.zeros((target, n_elevation), dtype=np.float32)
    for i in range(target):
        start = (i * n_elevation) // target
        end = -((-(i + 1) * n_elevation) // target)  # ceil
        P[i, start:end] = 1.0 / (end - start)
    return P


def dft_bases(n_azimuth: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases (A, n_freqs) so that for a real row x,
    rfft(x)[k] = x·cos_base[:,k] − i·x·sin_base[:,k] (unnormalized).
    Copied from JAX ``spectral.dft_bases`` (spectral.py:122)."""
    n_freqs = n_azimuth // 2 + 1
    n = np.arange(n_azimuth)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * n * k / n_azimuth
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _normalize_histogram(hist: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Global sum-to-1 with uniform fallback (JAX ``_normalize_histogram``)."""
    s = hist.sum(dim=-1, keepdim=True)
    uniform = torch.ones_like(hist) / hist.shape[-1]
    return torch.where(s > epsilon, hist / (s + epsilon), uniform)


def encode_range_image_batch(imgs: torch.Tensor, alpha: Alpha,
                             config: SpectralEncoderConfig) -> torch.Tensor:
    """(B, E, A) → (B, target·n_bins): pool → |rfft| → bin → normalise
    (JAX ``encode_range_image_batch``, spectral.py:154-171). No
    interpolation here; see ``encode_images``."""
    b, n_elev, _ = imgs.shape
    if n_elev != config.target_elevation_bins:
        P = torch.from_numpy(
            pooling_matrix(n_elev, config.target_elevation_bins)).to(imgs.device)
        imgs = torch.einsum("te,bea->bta", P, imgs)
    mags = torch.fft.rfft(imgs, dim=-1).abs()
    Bm = binning_matrix(alpha, config.n_bins, config.n_freqs, config.epsilon,
                        imgs.device)
    hist = torch.einsum("btf,fk->btk", mags, Bm).reshape(b, -1)
    return _normalize_histogram(hist, config.epsilon)


def encode_images_plain(imgs: torch.Tensor, alpha: Alpha,
                        config: SpectralEncoderConfig) -> torch.Tensor:
    """Plain PyTorch version of the fused spectral kernel: interpolation
    (when ``config.interpolate_empty``) then ``encode_range_image_batch``."""
    if config.interpolate_empty:
        imgs = interpolate_range_image(imgs)
    return encode_range_image_batch(imgs, alpha, config)


def encode_images(imgs: torch.Tensor, alpha: Alpha,
                  config: SpectralEncoderConfig) -> torch.Tensor:
    """(B, E, A) float32 range images → (B, output_dim) descriptors. A CPU
    tensor takes ``encode_images_plain``; a CUDA tensor launches the fused
    kernel (``ops/spectral_kernel.py``); any other device raises."""
    if imgs.device.type == "cpu":
        return encode_images_plain(imgs, alpha, config)
    from neural_spectral_codec_torch.ops.spectral_kernel import (
        encode_images_cuda)
    return encode_images_cuda(imgs, alpha, config)


def encode_range_image_numpy_50d(
    img: np.ndarray, n_bins: int = 50, alpha: float = 2.0,
    epsilon: float = 1e-8
) -> np.ndarray:
    """Torch-free 50-D variant of the reference's ``SpectralEncoderNumpy``:
    magnitudes summed over ALL elevation rows into one 50-bin histogram
    (no pooling). Copied from JAX ``spectral.encode_range_image_numpy_50d``
    (spectral.py:210)."""
    n_freqs = img.shape[1] // 2 + 1
    mags = np.abs(np.fft.rfft(img, axis=1, norm="ortho")) \
        * math.sqrt(img.shape[1])
    t = np.linspace(0, 1, n_bins + 1)
    edges = (np.exp(alpha * t) - 1) / (np.exp(alpha) - 1 + epsilon) * n_freqs
    freqs = np.arange(n_freqs)
    hist = np.zeros(n_bins)
    for i in range(n_bins):
        m = (freqs >= edges[i]) & (freqs < edges[i + 1])
        if m.any():
            hist[i] = mags[:, m].sum()
    s = hist.sum()
    if s > epsilon:
        return hist / (s + epsilon)
    return np.ones(n_bins) / n_bins


def encode_points_batch(points: torch.Tensor, alpha: Alpha,
                        config: SpectralEncoderConfig) -> torch.Tensor:
    """(B, N, 3|4) padded clouds → (B, output_dim) descriptors: general
    projection, then the spectral encoder (JAX ``encode_points_batch``,
    spectral.py:184)."""
    imgs = project_points_batch(points, config.projection)
    return encode_images(imgs, alpha, config)


def encode_points(points: torch.Tensor, alpha: Alpha,
                  config: SpectralEncoderConfig) -> torch.Tensor:
    """(N, 3|4) padded cloud → (output_dim,) descriptor (JAX
    ``encode_points``, spectral.py:175)."""
    return encode_points_batch(points[None], alpha, config)[0]


def encode_range_image(img: torch.Tensor, alpha: Alpha,
                       config: SpectralEncoderConfig) -> torch.Tensor:
    """(E, A) range image → (output_dim,) descriptor without the
    interpolation of empty pixels (JAX ``encode_range_image``,
    spectral.py:146): the spectral kernel with ``interpolate_empty``
    off on a card, ``encode_range_image_batch`` on the CPU."""
    return encode_images(img[None], alpha,
                         config._replace(interpolate_empty=False))[0]


def encode_clouds(clouds, max_points: int, config: SpectralEncoderConfig,
                  alpha: Alpha = 2.0,
                  device: DeviceLike = "cuda") -> torch.Tensor:
    """Unpadded (N_i, 3|4) numpy clouds → (B, output_dim) descriptors on
    ``device``: each cloud NaN-padded or cut to ``max_points``, then one
    ``encode_points_batch``."""
    batch = np.stack([pad_points(np.asarray(c), max_points) for c in clouds])
    return encode_points_batch(
        torch.from_numpy(batch).to(resolve_device(device)), alpha, config)


class SpectralEncoder:
    """The reference encoder's surface (``encode_points``,
    ``encode_range_image``, ``forward``) over the batch entry points, on
    ``device``; numpy in, numpy out (JAX ``SpectralEncoder``,
    spectral.py:233). A cloud is NaN-padded or cut to ``max_points``."""

    def __init__(self, n_elevation: int = 64, n_azimuth: int = 360,
                 n_bins: int = 50, target_elevation_bins: int = 16,
                 alpha: float = 2.0, interpolate_empty: bool = True,
                 elevation_range: Tuple[float, float] = (-24.8, 2.0),
                 max_range: float = 80.0, min_range: float = 1.0,
                 max_points: int = 131072, device: DeviceLike = "cuda"):
        self.config = SpectralEncoderConfig(
            n_elevation=n_elevation, n_azimuth=n_azimuth, n_bins=n_bins,
            target_elevation_bins=target_elevation_bins, alpha=alpha,
            interpolate_empty=interpolate_empty,
            elevation_range_deg=tuple(elevation_range),
            max_range=max_range, min_range=min_range)
        self.alpha = alpha
        self.max_points = max_points
        self.device = resolve_device(device)

    @property
    def output_dim(self) -> int:
        return self.config.output_dim

    def encode_points(self, points: np.ndarray) -> np.ndarray:
        """(N, 3|4) unpadded cloud → (output_dim,) descriptor."""
        return self.forward([points])[0]

    def encode_range_image(self, img: np.ndarray) -> np.ndarray:
        """(E, A) range image → descriptor, empty pixels interpolated
        when the config says so."""
        x = torch.from_numpy(np.asarray(img, np.float32)).to(self.device)
        return encode_images(x[None], self.alpha,
                             self.config)[0].cpu().numpy()

    def forward(self, clouds) -> np.ndarray:
        """Unpadded clouds → (B, output_dim), one device batch."""
        return encode_clouds(clouds, self.max_points, self.config,
                             self.alpha, self.device).cpu().numpy()

    __call__ = forward


class SpectralEncoderNumpy:
    """The reference's 50-D variant (JAX ``SpectralEncoderNumpy``,
    spectral.py:290): the range image from ``RangeImageProjector`` on
    ``device``, then ``encode_range_image_numpy_50d`` on the host."""

    def __init__(self, n_elevation: int = 64, n_azimuth: int = 360,
                 n_bins: int = 50, alpha: float = 2.0,
                 elevation_range: Tuple[float, float] = (-24.8, 2.0),
                 max_range: float = 80.0, min_range: float = 1.0,
                 max_points: int = 131072, device: DeviceLike = "cuda"):
        self.projector = RangeImageProjector(
            n_elevation=n_elevation, n_azimuth=n_azimuth,
            elevation_range=elevation_range, max_range=max_range,
            min_range=min_range, max_points=max_points, device=device)
        self.n_bins = n_bins
        self.alpha = alpha
        self.max_points = max_points

    def encode_points(self, points: np.ndarray) -> np.ndarray:
        img, _ = self.projector.project(points)
        return self.encode_range_image(img)

    def encode_range_image(self, img: np.ndarray) -> np.ndarray:
        return encode_range_image_numpy_50d(np.asarray(img), self.n_bins,
                                            self.alpha)
