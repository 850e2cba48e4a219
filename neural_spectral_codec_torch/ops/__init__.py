"""Array ops of the port: projection, spectral encoding, W₁.

Each hand-written CUDA kernel has a binding module (``*_kernel.py``) and a
plain PyTorch version beside its wrapper; the wrapper takes the plain
version for a CPU tensor and launches the kernel for a CUDA tensor.
"""

from neural_spectral_codec_torch.ops.range_image import (  # noqa: F401
    ProjectionConfig, interpolate_range_image, pad_points,
    project_points_batch, project_points_batch_plain)
from neural_spectral_codec_torch.ops.ring_path import (  # noqa: F401
    encode_points_ring_batch, make_structured_ring_scans,
    project_rings_batch, project_rings_batch_plain)
from neural_spectral_codec_torch.ops.spectral import (  # noqa: F401
    SpectralEncoderConfig, encode_images, encode_images_plain,
    encode_points_batch, encode_range_image_batch)
from neural_spectral_codec_torch.ops.wasserstein import (  # noqa: F401
    histogram_cdf, wasserstein_batch_from_cdf)
