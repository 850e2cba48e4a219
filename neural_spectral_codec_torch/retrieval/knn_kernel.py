"""The verifier's k-nearest-neighbour search within one cloud: its plain
PyTorch version and the binding of its hand-written kernel,
``csrc/knn.cu`` (kernel K).

It is no Pallas kernel's port: the JAX package leaves this selection to
XLA inside its per-cloud preparation (``neural_spectral_codec_tpu/
retrieval/verification.py`` ``_knn_cov_matrices``, :64-73: ``lax.top_k``
over the negated masked distance matrix), which ``verification.
knn_covariances`` and ``knn_normals`` port with ``pca_kernel``.

``knn(pts, mask, k)`` returns (P, k) indices per point in ascending
squared distance with ties to the lower index, the order of
``lax.top_k`` (XLA's TopK puts the lower index first among equal values)
and of a stable sort; masked points count as +inf, so a row with fewer
than k valid points ends with masked indices in ascending order. A CPU
tensor takes the plain version, a CUDA tensor the kernel (or the binding
raises), which takes k ≤ 32. The kernel runs one warp for two rows and
visits their own 32-point batch first, then the batches out from it both
ways, so that on a voxel-sorted cloud the k-th distance is near its final
value at once and a 32-bit test skips most batches (``csrc/knn.cu``'s
header has the design).
"""

from __future__ import annotations

import ctypes

import torch

from neural_spectral_codec_torch._build import CudaKernel
from neural_spectral_codec_torch.retrieval.nearest_kernel import (
    check_device, check_mask, check_points, pairwise_d2)

KERNEL = CudaKernel("nsc_knn", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])
MAX_K = 32          # one key a lane of a warp


def knn_plain(pts: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """(P, k) int64: the first k columns of each row of the masked (P, P)
    distance matrix in a stable ascending sort."""
    d2 = torch.where(mask[None, :], pairwise_d2(pts, pts), torch.inf)
    return torch.sort(d2, dim=1, stable=True).indices[:, :k]


def knn_cuda(pts: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Launch kernel K: (P, 3) float32 and (P,) bool CUDA tensors → (P, k)
    int64 indices, 1 ≤ k ≤ min(32, P). Shapes, types, contiguity and k are
    checked first (``ValueError``, nothing launched)."""
    n = check_points(pts, "knn_cuda pts")
    check_mask(mask, n, "knn_cuda mask")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"knn_cuda: k = {k}; the kernel takes 1 <= k <= "
                         f"min({MAX_K}, P = {n})")
    dev = check_device("knn_cuda", pts, mask)
    idx = torch.empty((n, k), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        KERNEL(pts.data_ptr(), mask.data_ptr(), idx.data_ptr(), n, k,
               torch.cuda.current_stream(dev).cuda_stream)
    return idx


def knn(pts: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel K on CUDA tensors, its plain version on CPU tensors."""
    if pts.device.type == "cpu":
        return knn_plain(pts, mask, k)
    return knn_cuda(pts, mask, k)
