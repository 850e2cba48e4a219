"""Descriptor quantization and the fixed-size binary record store.

Port of ``neural_spectral_codec_tpu/ops/quantization.py``:

  * ``quantize`` / ``dequantize``: uint16 codes with the rounding error
    added to the first largest bin, so the codes sum to 65535 (JAX
    quantization.py:40, :63).
  * ``CompressedDescriptor``: one record, ``2·n_bins + 120`` bytes (220 B
    at 50 bins, 1,720 B at 800): the codes, a 7-DoF pose, a float64
    timestamp, a uint32 id, the SHA-1 of the xyz coordinates and 60
    reserved bytes. ``DescriptorDatabaseFile`` is the append-only store.
    The 7-DoF pose helpers live in ``data/pose_utils.py``.

Records are byte-identical to the JAX package's, so a store written by
one package loads in the other. For that the row sum inside ``quantize``
adds in the order XLA's CPU backend does (``xla_row_sum``): a float32 sum
differs in the last bit between orders, and one bit of the divisor moves
a code now and then. A histogram whose sum lies just above ε keeps the
reference's behaviour bit for bit, including its large dequantisation
error (the known sub-ε defect, ROADMAP queue 3).
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from neural_spectral_codec_torch.data.pose_utils import (  # noqa: F401
    matrix_to_quat_wxyz, pose_from_7dof, pose_to_7dof, quat_wxyz_to_matrix)

MAX_U16 = 65535
METADATA_BYTES = 120  # pose 28 + ts 8 + id 4 + hash 20 + reserved 60
_XLA_WINDOW = 32


def record_size(n_bins: int = 50) -> int:
    """Total serialized bytes for an ``n_bins`` descriptor (220 for 50)."""
    return 2 * n_bins + METADATA_BYTES


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA's CPU order: a row of at least 32
    values is padded with zeros to a multiple of 32 (half the padding in
    front), each window of 32 is summed left to right, and the window sums
    are reduced the same way; a shorter row is summed left to right."""
    n = x.shape[-1]
    if n == 0:
        return x.sum(dim=-1)
    if n < _XLA_WINDOW:
        return _sequential_sum(x)
    pad = (-n) % _XLA_WINDOW
    if pad:
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    parts = _sequential_sum(x.reshape(*x.shape[:-1], -1, _XLA_WINDOW))
    return xla_row_sum(parts)


def quantize(histogram: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """(..., n) histogram → uint16 codes summing to 65535 (when any code
    is nonzero): normalise by ``sum + ε`` when the sum exceeds ε, round
    half to even, add the shortfall to the first largest code, clipped to
    [0, 65535]. Returned as int32 tensor values (torch has no uint16
    arithmetic); ``quantize_numpy`` gives the uint16 array."""
    h = histogram.to(torch.float32)
    s = xla_row_sum(h)[..., None]
    eps = torch.tensor(epsilon, dtype=torch.float32, device=h.device)
    h = torch.where(s > eps, h / (s + eps), h)
    q = torch.round(h * MAX_U16).to(torch.int32)
    qsum = q.sum(dim=-1, keepdim=True, dtype=torch.int32)
    max_idx = torch.argmax(q, dim=-1, keepdim=True)     # first largest
    corrected = torch.clamp(q.gather(-1, max_idx) + (MAX_U16 - qsum), 0,
                            MAX_U16)
    fixed = q.scatter(-1, max_idx, corrected)
    return torch.where(qsum > 0, fixed, q)


def dequantize(quantized: torch.Tensor, epsilon: float = 1e-8
               ) -> torch.Tensor:
    """uint16 codes → float32 histogram ``codes / (sum + ε)``; a row whose
    codes sum to 0 becomes uniform."""
    h = quantized.to(torch.float32)
    s = h.sum(dim=-1, keepdim=True)        # integers: exact in any order
    uniform = torch.ones_like(h) / h.shape[-1]
    return torch.where(s > epsilon, h / (s + epsilon), uniform)


def quantize_numpy(histogram: np.ndarray, epsilon: float = 1e-8
                   ) -> np.ndarray:
    return quantize(torch.from_numpy(np.asarray(histogram, np.float32)),
                    epsilon).numpy().astype(np.uint16)


def dequantize_numpy(quantized: np.ndarray, epsilon: float = 1e-8
                     ) -> np.ndarray:
    q = torch.from_numpy(np.asarray(quantized, np.uint16).astype(np.int32))
    return dequantize(q, epsilon).numpy()


class HistogramQuantizer:
    """Class-style surface over :func:`quantize` / :func:`dequantize` on
    numpy arrays."""

    def __init__(self, n_bins: int = 50, epsilon: float = 1e-8):
        self.n_bins = n_bins
        self.epsilon = epsilon

    def _check(self, a: np.ndarray) -> None:
        if a.shape[-1] != self.n_bins:
            raise ValueError(
                f"expected {self.n_bins}-bin histogram, got {a.shape[-1]}")

    def quantize(self, histogram: np.ndarray) -> np.ndarray:
        h = np.asarray(histogram, np.float32)
        self._check(h)
        return quantize_numpy(h, self.epsilon)

    def dequantize(self, quantized: np.ndarray) -> np.ndarray:
        q = np.asarray(quantized, np.uint16)
        self._check(q)
        return dequantize_numpy(q, self.epsilon)


def compute_point_cloud_hash(points: np.ndarray) -> bytes:
    """SHA-1 of the float32 xyz bytes."""
    return hashlib.sha1(points[:, :3].astype(np.float32).tobytes()).digest()


@dataclass
class CompressedDescriptor:
    """One binary keyframe record (220 B at 50 bins)."""

    histogram: np.ndarray  # (n_bins,) uint16
    pose: np.ndarray  # (7,) float32 [x, y, z, qw, qx, qy, qz]
    timestamp: float
    keyframe_id: int
    point_cloud_hash: bytes  # 20 bytes

    def to_bytes(self) -> bytes:
        out = (self.histogram.astype(np.uint16).tobytes()
               + self.pose.astype(np.float32).tobytes()
               + struct.pack("d", self.timestamp)
               + struct.pack("I", self.keyframe_id)
               + self.point_cloud_hash
               + bytes(60))
        if len(out) != record_size(len(self.histogram)):
            raise ValueError(f"record of {len(out)} bytes")
        return out

    @staticmethod
    def from_bytes(data: bytes) -> "CompressedDescriptor":
        n_bins = (len(data) - METADATA_BYTES) // 2
        h_end = 2 * n_bins
        return CompressedDescriptor(
            histogram=np.frombuffer(data[:h_end], dtype=np.uint16).copy(),
            pose=np.frombuffer(data[h_end:h_end + 28],
                               dtype=np.float32).copy(),
            timestamp=struct.unpack("d", data[h_end + 28:h_end + 36])[0],
            keyframe_id=struct.unpack("I", data[h_end + 36:h_end + 40])[0],
            point_cloud_hash=data[h_end + 40:h_end + 60],
        )


def compress_descriptor(histogram: np.ndarray, pose: np.ndarray,
                        timestamp: float, keyframe_id: int,
                        points: np.ndarray) -> CompressedDescriptor:
    return CompressedDescriptor(
        histogram=quantize_numpy(histogram),
        pose=pose_to_7dof(pose).astype(np.float32),
        timestamp=timestamp,
        keyframe_id=keyframe_id,
        point_cloud_hash=compute_point_cloud_hash(points),
    )


def compress_descriptors(histograms: np.ndarray, poses: np.ndarray,
                         timestamps, keyframe_ids, hashes) -> bytes:
    """Records of many keyframes at once, as one bytes object: the codes
    of all rows come from one ``quantize`` call (the same codes row by
    row, since each row's sum is its own)."""
    codes = quantize_numpy(np.asarray(histograms, np.float32))
    return b"".join(
        CompressedDescriptor(codes[i], pose_to_7dof(poses[i]).astype(
            np.float32), float(timestamps[i]), int(keyframe_ids[i]),
            hashes[i]).to_bytes() for i in range(len(codes)))


def decompress_descriptor(desc: CompressedDescriptor):
    """→ (histogram float32, pose (4,4), timestamp, keyframe_id)."""
    h = dequantize_numpy(desc.histogram)
    return (h, pose_from_7dof(desc.pose.astype(np.float64)), desc.timestamp,
            desc.keyframe_id)


class DescriptorDatabaseFile:
    """Append-only flat binary store of fixed-size descriptor records; a
    torn final record is dropped on read."""

    def __init__(self, path: str, n_bins: int = 50):
        self.path = path
        self.n_bins = n_bins
        self.rec = record_size(n_bins)

    def append(self, desc: CompressedDescriptor) -> None:
        with open(self.path, "ab") as f:
            f.write(desc.to_bytes())

    def _read(self) -> bytes:
        try:
            with open(self.path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return b""

    def read_all(self) -> List[CompressedDescriptor]:
        data = self._read()
        n = len(data) // self.rec
        return [CompressedDescriptor.from_bytes(
            data[i * self.rec:(i + 1) * self.rec]) for i in range(n)]

    def read_arrays(self, limit: Optional[int] = None):
        """The first ``limit`` records (all by default) as arrays: (number
        of whole records in the file, (n, n_bins) uint16 codes, (n, 7)
        float32 poses, (n,) float64 timestamps, (n,) uint32 ids)."""
        data = self._read()
        total = len(data) // self.rec
        n = total if limit is None else min(total, limit)
        raw = np.frombuffer(data, np.uint8, count=n * self.rec).reshape(
            n, self.rec)
        h = 2 * self.n_bins
        return (total, raw[:, :h].copy().view(np.uint16),
                raw[:, h:h + 28].copy().view(np.float32),
                raw[:, h + 28:h + 36].copy().view(np.float64)[:, 0],
                raw[:, h + 36:h + 40].copy().view(np.uint32)[:, 0])
