"""The verifier's nearest-neighbour search: its plain PyTorch version and
the binding of its hand-written kernel, ``csrc/nearest.cu`` (kernel N).

It is no Pallas kernel's port: the JAX package leaves this search to XLA
inside its registration program (``neural_spectral_codec_tpu/retrieval/
verification.py`` ``_icp_kernel``, ``correspondences``, :124-131), which
the port captures as one CUDA graph (``verification.
RegistrationExecutable``); the search is the O(P·Q) part of it.

``nearest(moved, dst, dst_mask)`` returns, for every row of ``moved``, the
index of the nearest valid row of ``dst`` and its squared distance: masked
targets count as +inf, ties go to the lower index, and a NaN distance wins
(the first NaN, as ``torch.argmin`` and ``jnp.argmin`` return it). A CPU
tensor takes the plain version, a CUDA tensor the kernel (or the binding
raises); the two agree bit for bit because both sum the squared
differences as ``pairwise_d2`` does, without FMA contraction.

The kernel holds two source points a lane, 64 a CTA of 32 warps that
split the CTA's targets, and a cluster of ``CLUSTER`` CTAs splits the
targets again; each thread keeps a 32-bit least distance and the group of
8 targets that holds it, and the index is found again once a row
(``csrc/nearest.cu``'s header has the design).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from neural_spectral_codec_torch._build import CudaKernel, check_contiguous

KERNEL = CudaKernel("nsc_nearest", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
CLUSTER = 2         # CTAs of a cluster (kCluster in csrc/nearest.cu)
ROWS_PER_CTA = 64   # source points a CTA holds (kRowsPerCta)


def pairwise_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P, Q) squared distances summed over the coordinates of the
    differences as the JAX package does (not the |a|²+|b|²−2ab form), in
    the order the kernels sum them: (dx² + dy²) + dz², each product and sum
    rounded on its own."""
    d = a[:, None, :] - b[None, :, :]
    sq = d * d
    return sq[..., 0] + sq[..., 1] + sq[..., 2]


def check_points(pts: torch.Tensor, what: str) -> int:
    """Rows of a (n, 3) float32 contiguous point tensor, n ≥ 1; raises
    ``ValueError`` otherwise."""
    if pts.dim() != 2 or pts.shape[1] != 3 or pts.shape[0] < 1:
        raise ValueError(f"{what}: expected (n, 3) points with n >= 1, got "
                         f"{tuple(pts.shape)}")
    if pts.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32 points, got {pts.dtype}")
    check_contiguous(pts, what)
    return int(pts.shape[0])


def check_mask(mask: torch.Tensor, n: int, what: str) -> None:
    """A contiguous (n,) bool mask; raises ``ValueError`` otherwise."""
    if mask.shape != (n,) or mask.dtype != torch.bool:
        raise ValueError(f"{what}: expected a ({n},) bool mask, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    check_contiguous(mask, what)


def check_device(what: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device of ``tensors``; raises ``ValueError`` for a CPU
    tensor or tensors on two devices."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    return dev


def nearest_plain(moved: torch.Tensor, dst: torch.Tensor,
                  dst_mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(j, d2min): the argmin of each row of the masked (P, Q) distance
    matrix, as JAX's ``correspondences`` takes it."""
    d2 = torch.where(dst_mask[None, :], pairwise_d2(moved, dst), torch.inf)
    j = torch.argmin(d2, dim=1)
    return j, d2.gather(1, j[:, None])[:, 0]


def nearest_cuda(moved: torch.Tensor, dst: torch.Tensor,
                 dst_mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel N: (P, 3) and (Q, 3) float32, (Q,) bool CUDA tensors →
    (j (P,) int64, d2min (P,) float32). Shapes, types and contiguity are
    checked first (``ValueError``, nothing launched)."""
    n_src = check_points(moved, "nearest_cuda moved")
    n_dst = check_points(dst, "nearest_cuda dst")
    check_mask(dst_mask, n_dst, "nearest_cuda dst_mask")
    dev = check_device("nearest_cuda", moved, dst, dst_mask)
    j = torch.empty(n_src, dtype=torch.int64, device=dev)
    d2 = torch.empty(n_src, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        KERNEL(moved.data_ptr(), dst.data_ptr(), dst_mask.data_ptr(),
               j.data_ptr(), d2.data_ptr(), n_src, n_dst,
               torch.cuda.current_stream(dev).cuda_stream)
    return j, d2


def nearest(moved: torch.Tensor, dst: torch.Tensor, dst_mask: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel N on CUDA tensors, its plain version on CPU tensors."""
    if moved.device.type == "cpu":
        return nearest_plain(moved, dst, dst_mask)
    return nearest_cuda(moved, dst, dst_mask)
