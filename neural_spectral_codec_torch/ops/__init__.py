"""Array ops of the port: projection, spectral encoding, W₁.

Each hand-written CUDA kernel has a binding module (``*_kernel.py``) and a
plain PyTorch version beside its wrapper; the wrapper takes the plain
version for a CPU tensor and launches the kernel for a CUDA tensor.
Importing builds no kernel. The names below are those of
``neural_spectral_codec_tpu.ops`` plus the port's plain versions.
"""

from neural_spectral_codec_torch.ops.range_image import (  # noqa: F401
    ProjectionConfig, interpolate_range_image, pad_points, project_points,
    project_points_batch, project_points_batch_plain, range_image_difference,
    unproject_range_image)
from neural_spectral_codec_torch.ops.ring_path import (  # noqa: F401
    encode_points_ring_batch, encode_structured, infer_ring_ids_by_elevation,
    infer_ring_ids_from_sweep, infer_row_of_ring, make_structured_ring_scans,
    points_to_rings, project_rings_batch, project_rings_batch_plain,
    ring_structure_report)
from neural_spectral_codec_torch.ops.spectral import (  # noqa: F401
    SpectralEncoderConfig, binning_matrix, compute_bin_edges, encode_clouds,
    encode_images,
    encode_images_plain, encode_points, encode_points_batch,
    encode_range_image, encode_range_image_batch, pooling_matrix)
from neural_spectral_codec_torch.ops.quantization import (  # noqa: F401
    HistogramQuantizer, dequantize, quantize)
from neural_spectral_codec_torch.ops.wasserstein import (  # noqa: F401
    histogram_cdf, wasserstein_1d, wasserstein_batch,
    wasserstein_batch_from_cdf, wasserstein_matrix)
