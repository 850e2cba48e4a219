"""The verifier's two small eigen-solve kernels: their plain PyTorch
versions and the bindings of their hand-written kernels, ``csrc/knn_pca.cu``
(kernel C) and ``csrc/kabsch.cu`` (kernel R), which share the Jacobi solve
of ``csrc/sym3.cuh``.

Neither is a Pallas kernel's port: the JAX package leaves both to XLA
inside its one-dispatch programs (``neural_spectral_codec_tpu/retrieval/
verification.py``):

  * C, ``knn_pca(pts, idx, mode, eps)``: the k-NN PCA of every point
    (``_knn_cov_matrices``, :64-73) to its unit normal (``_knn_normals``,
    :77) or its disk-regularised GICP covariance V diag(ε, 1, 1) Vᵀ
    (``_knn_covariances``, :85), from kernel K's neighbour indices.
  * R, ``p2p_update(src, src_mask, dst, j, d2, max_corr)``: the whole
    point-to-point step after kernel N (``_icp_kernel``'s correspondence
    weights, :129-131, and ``p2p_step``, :133-146): the weights, the
    weighted centroids and H, then R from the SVD of H with the reflection
    fixed, t = q_c − R p_c, as a (4, 4) transform. ``kabsch_cuda(H, p_c,
    q_c)`` is its solve alone (a second entry point of the same kernel
    source, not on the main path: tests and ``chip_smoke.py`` hold the
    solve on its edge cases with it against ``kabsch_plain``).

Their PyTorch forms (``torch.linalg.eigh``, ``svd``, ``det``) copy through
the host on a card, which a CUDA graph refuses; the kernels do the solves
in float64 (the kernels' headers have the design), so that ``prepare`` and
the point-to-point registration each run as one captured graph. A CPU
tensor takes the plain version, a CUDA tensor the kernel (or the binding
raises).

The two agree up to the float32 sums' and solve's error and, for C, the
normal's sign: the kernel makes the normal's largest-magnitude component
positive (point-to-plane and the covariance are blind to the sign), and
where eigenvalues tie it takes the eigenvector of the first, as ``eigh``
does for a zero matrix. R and the SVD formula agree where the optimal
rotation is unique; for a rank-1 H both are optimal proper rotations.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neural_spectral_codec_torch._build import CudaKernel
from neural_spectral_codec_torch.retrieval.nearest_kernel import (
    check_device, check_mask, check_points)

KNN_PCA = CudaKernel("nsc_knn_pca", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
KABSCH = CudaKernel("nsc_kabsch", [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
KABSCH_SOLVE = CudaKernel("nsc_kabsch_solve", [ctypes.c_void_p] * 5)
PCA_MODES = ("normals", "covariances")
# kernel R's layout: a cluster of up to P2P_MAX_CTAS CTAs of P2P_THREADS
# threads (kThreads, kMaxCtas in csrc/kabsch.cu), P2P_POINTS points a thread
# (each holds up to 4 in registers)
P2P_THREADS = 256
P2P_MAX_CTAS = 8
P2P_POINTS = 2


def _out_shape(n: int, mode: str) -> tuple:
    if mode not in PCA_MODES:
        raise ValueError(f"knn_pca: mode {mode!r}, not one of {PCA_MODES}")
    return (n, 3) if mode == "normals" else (n, 3, 3)


def cov_matrices(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Raw PCA covariance of each point's neighbours ``pts[idx]``, (P, 3, 3):
    the mean over k, then Σ c cᵀ / k (JAX ``_knn_cov_matrices``)."""
    nbr = pts[idx]                                        # (P, k, 3)
    c = nbr - nbr.mean(dim=1, keepdim=True)
    return torch.einsum("pki,pkj->pij", c, c) / idx.shape[1]


def knn_pca_plain(pts: torch.Tensor, idx: torch.Tensor, mode: str,
                  eps: float = 1e-3) -> torch.Tensor:
    """The normal (smallest-eigenvalue eigenvector, sign as ``eigh`` gives
    it) or the covariance V diag(ε, 1, 1) Vᵀ of each point's k-NN
    covariance, with ``torch.linalg.eigh`` (ascending eigenvalues)."""
    _out_shape(pts.shape[0], mode)
    _, vecs = torch.linalg.eigh(cov_matrices(pts, idx))
    if mode == "normals":
        return vecs[:, :, 0]
    d = torch.ones(3, dtype=vecs.dtype, device=vecs.device)
    d[0] = eps
    return torch.einsum("pij,j,pkj->pik", vecs, d, vecs)


def knn_pca_cuda(pts: torch.Tensor, idx: torch.Tensor, mode: str,
                 eps: float = 1e-3,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch kernel C: (P, 3) float32 points and (P, k) int64 neighbour
    indices (k ≥ 1, each in [0, P): kernel K's output) on one card → the
    (P, 3) normals or (P, 3, 3) covariances, written into ``out`` when
    given (a contiguous float32 tensor of that shape). Shapes, types and
    contiguity are checked first (``ValueError``, nothing launched); the
    index values are not."""
    n = check_points(pts, "knn_pca_cuda pts")
    shape = _out_shape(n, mode)
    if (idx.dtype != torch.int64 or idx.dim() != 2 or idx.shape[0] != n
            or idx.shape[1] < 1 or not idx.is_contiguous()):
        raise ValueError(f"knn_pca_cuda idx: expected a contiguous ({n}, k)"
                         f" int64 tensor, k >= 1, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    dev = check_device("knn_pca_cuda", pts, idx,
                       *(() if out is None else (out,)))
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or not out.is_contiguous()):
        raise ValueError(f"knn_pca_cuda out: expected a contiguous {shape} "
                         f"float32 tensor, got {tuple(out.shape)} "
                         f"{out.dtype}")
    with torch.cuda.device(dev):
        KNN_PCA(pts.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                idx.shape[1], int(mode == "normals"), float(eps),
                torch.cuda.current_stream(dev).cuda_stream)
    return out


def knn_pca(pts: torch.Tensor, idx: torch.Tensor, mode: str,
            eps: float = 1e-3,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel C on CUDA tensors, its plain version on CPU tensors (copied
    into ``out`` when given)."""
    if pts.device.type == "cpu":
        got = knn_pca_plain(pts, idx, mode, eps)
        return got if out is None else out.copy_(got)
    return knn_pca_cuda(pts, idx, mode, eps, out)


def kabsch_plain(h: torch.Tensor, p_c: torch.Tensor,
                 q_c: torch.Tensor) -> torch.Tensor:
    """JAX's weighted Kabsch step: U, S, Vᵀ = svd(H), d = sign(det(V Uᵀ)),
    R = V diag(1, 1, d) Uᵀ, t = q_c − R p_c, as a (4, 4) transform."""
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = vt.T @ D @ u.T
    T = torch.eye(4, dtype=h.dtype, device=h.device)
    T[:3, :3] = R
    T[:3, 3] = q_c - R @ p_c
    return T


def p2p_update_plain(src: torch.Tensor, src_mask: torch.Tensor,
                     dst: torch.Tensor, j: torch.Tensor, d2: torch.Tensor,
                     max_corr: float) -> torch.Tensor:
    """JAX's point-to-point step after the argmin, in float32: the weights
    w = mask & (√d2 ≤ max_corr), q = dst[j], sw = max(Σ w, 1e-6), the
    weighted centroids and H = Σ ((src − p_c) w)(q − q_c)ᵀ, then
    ``kabsch_plain``."""
    w = (src_mask & (torch.sqrt(d2) <= max_corr)).to(torch.float32)
    q = dst[j]
    sw = w.sum().clamp(min=1e-6)
    # weighted Kabsch from the ORIGINAL source to the matched targets
    p_c = (src * w[:, None]).sum(0) / sw
    q_c = (q * w[:, None]).sum(0) / sw
    H = torch.einsum("ni,nj->ij", (src - p_c) * w[:, None], q - q_c)
    return kabsch_plain(H, p_c, q_c)


def _check_small(t: torch.Tensor, shape: tuple, what: str) -> None:
    if (tuple(t.shape) != shape or t.dtype != torch.float32
            or not t.is_contiguous()):
        raise ValueError(f"{what}: expected a contiguous {shape} float32 "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")


def p2p_layout(n: int) -> int:
    """The CTAs of kernel R's cluster (of P2P_THREADS threads each) for
    ``n`` source points: P2P_POINTS a thread, 1 to P2P_MAX_CTAS."""
    per_cta = P2P_THREADS * P2P_POINTS
    return min(P2P_MAX_CTAS, max(1, -(-n // per_cta)))


def p2p_update_cuda(src: torch.Tensor, src_mask: torch.Tensor,
                    dst: torch.Tensor, j: torch.Tensor, d2: torch.Tensor,
                    max_corr: float) -> torch.Tensor:
    """Launch kernel R: src (P, 3) float32, src_mask (P,) bool, dst (Q, 3)
    float32 and kernel N's j (P,) int64 (each in [0, Q)) and d2 (P,)
    float32, all on one card → the step's (4, 4) float32 transform, one
    cluster of ``p2p_layout(P)`` CTAs. Shapes, types and contiguity are
    checked first (``ValueError``, nothing launched); the index values are
    not."""
    n = check_points(src, "p2p_update_cuda src")
    check_points(dst, "p2p_update_cuda dst")
    check_mask(src_mask, n, "p2p_update_cuda src_mask")
    for t, dtype, what in ((j, torch.int64, "j"), (d2, torch.float32, "d2")):
        if tuple(t.shape) != (n,) or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"p2p_update_cuda {what}: expected a contiguous "
                             f"({n},) {dtype} tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
    dev = check_device("p2p_update_cuda", src, src_mask, dst, j, d2)
    T = torch.empty((4, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        KABSCH(src.data_ptr(), src_mask.data_ptr(), dst.data_ptr(),
               j.data_ptr(), d2.data_ptr(), T.data_ptr(), n, float(max_corr),
               p2p_layout(n), torch.cuda.current_stream(dev).cuda_stream)
    return T


def p2p_update(src: torch.Tensor, src_mask: torch.Tensor, dst: torch.Tensor,
               j: torch.Tensor, d2: torch.Tensor,
               max_corr: float) -> torch.Tensor:
    """Kernel R on CUDA tensors, its plain version on CPU tensors."""
    if src.device.type == "cpu":
        return p2p_update_plain(src, src_mask, dst, j, d2, max_corr)
    return p2p_update_cuda(src, src_mask, dst, j, d2, max_corr)


def kabsch_cuda(h: torch.Tensor, p_c: torch.Tensor,
                q_c: torch.Tensor) -> torch.Tensor:
    """Launch kernel R's solve alone (``nsc_kabsch_solve``, not on the main
    path): H (3, 3), p_c and q_c (3,) float32 on one card → the (4, 4)
    float32 transform. Shapes, types and contiguity are checked first
    (``ValueError``, nothing launched)."""
    _check_small(h, (3, 3), "kabsch_cuda H")
    _check_small(p_c, (3,), "kabsch_cuda p_c")
    _check_small(q_c, (3,), "kabsch_cuda q_c")
    dev = check_device("kabsch_cuda", h, p_c, q_c)
    T = torch.empty((4, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        KABSCH_SOLVE(h.data_ptr(), p_c.data_ptr(), q_c.data_ptr(),
                     T.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return T

