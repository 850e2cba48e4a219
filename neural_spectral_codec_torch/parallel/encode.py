"""Batch-sharded descriptor encoding.

Port of ``neural_spectral_codec_tpu/parallel/encode.py``. A scan is
encoded on its own, so the batch splits into one slab per mesh device
with no collective: each slab is encoded on its device (on a CUDA device
the general path launches ``csrc/project.cu`` and ``csrc/spectral.cu``,
the ring path ``csrc/ring_fold.cu`` and ``csrc/spectral.cu``, once per
slab), and the descriptors come back on ``mesh.devices[0]`` in batch
order. The launches of the slabs are queued without a synchronisation, so
slabs on distinct cards run at the same time.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from neural_spectral_codec_torch.ops.spectral import (
    SpectralEncoderConfig, encode_points_batch)
from neural_spectral_codec_torch.parallel.mesh import (
    Mesh, all_gather, shard_array)


def _sharded(mesh: Mesh, encode_slab: Callable) -> Callable:
    def encode(points, alpha) -> torch.Tensor:
        out = []
        for slab in shard_array(points, mesh):
            a = alpha.to(slab.device) if torch.is_tensor(alpha) else alpha
            out.append(encode_slab(slab, a))
        return all_gather(out, mesh.devices[0])
    return encode


def make_sharded_encoder(config: SpectralEncoderConfig,
                         mesh: Mesh) -> Callable:
    """``fn(points (B, N, 3|4), alpha) -> (B, output_dim)`` descriptors on
    ``mesh.devices[0]``; B must be a multiple of the mesh size."""
    return _sharded(mesh, lambda p, a: encode_points_batch(p, a, config))


def make_sharded_ring_encoder(config: SpectralEncoderConfig, mesh: Mesh,
                              row_of_ring: Sequence[int]) -> Callable:
    """The ring path (``ops.ring_path.encode_points_ring_batch``) sharded
    the same way: ``fn(points (B, R, P, 3|4), alpha)``."""
    from neural_spectral_codec_torch.ops.ring_path import (
        encode_points_ring_batch)
    rows = tuple(int(v) for v in row_of_ring)
    return _sharded(mesh, lambda p, a: encode_points_ring_batch(
        p, a, config, rows))
