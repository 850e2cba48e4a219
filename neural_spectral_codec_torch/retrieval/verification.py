"""Geometric verification of loop-closure candidates.

Port of ``neural_spectral_codec_tpu/retrieval/verification.py``. A
candidate is accepted iff registration reaches fitness ≥ 0.3 and inlier
RMSE ≤ 0.5 m (1.0 m correspondences, 30 iterations, 0.3 m voxels); the
information matrix is the fitness-scaled diagonal heuristic.

Two backends, chosen once at construction:

  * ``"native"``: the host C++ library (``native/geom.py``: grid-accelerated
    correspondences, ctypes releases the GIL so candidates verify in
    parallel threads). ``"auto"`` means this one, and raises when the
    library cannot be built: no quiet fallback.
  * ``"torch"`` (also named ``"jax"``, the JAX package's name for it, so
    that its configs build): the fixed-shape registration of the JAX
    package's ``"jax"`` backend in plain PyTorch on the verifier's
    device: padded point sets,
    all-pairs nearest neighbours from a distance matrix, ``max_iterations``
    Gauss-Newton steps (``icp_kernel``: point-to-point Kabsch,
    point-to-plane, or generalized ICP with k-NN disk-regularised
    covariances on both clouds). The work grows as P² per iteration
    (16.8 M distances at P = 4,096), which suits the card.

Matrix products here are float32 with TF32 off (``resolve_device``).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Mean of the finite points per voxel (host numpy; copied from JAX
    verification.py:36)."""
    pts = points[:, :3]
    ok = np.isfinite(pts).all(axis=1)
    pts = pts[ok]
    if len(pts) == 0 or voxel_size <= 0:
        return pts
    v = np.floor(pts / voxel_size).astype(np.int64)
    off = 1 << 20
    key = ((v[:, 0] + off) << 42) | ((v[:, 1] + off) << 21) | (v[:, 2] + off)
    order = np.argsort(key)
    key, pts = key[order], pts[order]
    uniq, start, counts = np.unique(key, return_index=True, return_counts=True)
    sums = np.add.reduceat(pts, start, axis=0)
    return (sums / counts[:, None]).astype(np.float32)


def _pad(points: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 3) zero-padded points and their validity mask; an oversized
    cloud is subsampled with an even stride (JAX verification.py:53)."""
    out = np.zeros((n, 3), np.float32)
    m = np.zeros(n, bool)
    k = min(len(points), n)
    if k:
        sel = (np.linspace(0, len(points) - 1, k).astype(int)
               if len(points) > n else np.arange(k))
        out[:k] = points[sel, :3]
        m[:k] = True
    return out, m


def _pairwise_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P, Q) squared distances, summed over the coordinates of the
    differences as the JAX package does (not the |a|²+|b|²−2ab form)."""
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(dim=-1)


def knn_cov_matrices(pts: torch.Tensor, mask: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Raw k-NN PCA covariance per point, (P, 3, 3); the k neighbours
    include the point itself."""
    d2 = torch.where(mask[None, :], _pairwise_d2(pts, pts), torch.inf)
    idx = torch.topk(d2, k, dim=1, largest=False).indices
    nbr = pts[idx]                                       # (P, k, 3)
    c = nbr - nbr.mean(dim=1, keepdim=True)
    return torch.einsum("pki,pkj->pij", c, c) / k


def knn_normals(pts: torch.Tensor, mask: torch.Tensor,
                k: int = 16) -> torch.Tensor:
    """Unit normal per point: the eigenvector of the smallest eigenvalue
    of its k-NN covariance (sign arbitrary)."""
    _, vecs = torch.linalg.eigh(knn_cov_matrices(pts, mask, k))
    return vecs[:, :, 0]


def knn_covariances(pts: torch.Tensor, mask: torch.Tensor, k: int = 20,
                    eps: float = 1e-3) -> torch.Tensor:
    """GICP covariances V diag(ε, 1, 1) Vᵀ from the k-NN PCA eigenvectors
    (ascending eigenvalues): the normal direction squashed to ε."""
    _, vecs = torch.linalg.eigh(knn_cov_matrices(pts, mask, k))
    d = torch.tensor([eps, 1.0, 1.0], dtype=vecs.dtype, device=vecs.device)
    return torch.einsum("pij,j,pkj->pik", vecs, d, vecs)


def _transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ T[:3, :3].T + T[:3, 3]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) update for Gauss-Newton, xi = [ω, t]: Rodrigues rotation of
    ω, translation t (JAX ``_se3_exp``)."""
    w, t = xi[:3], xi[3:]
    th = torch.linalg.vector_norm(w) + 1e-12
    z = torch.zeros((), dtype=xi.dtype, device=xi.device)
    K = torch.stack([torch.stack([z, -w[2], w[1]]),
                     torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + torch.sin(th) / th * K + (1 - torch.cos(th)) / (th * th) * (K @ K)
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def icp_kernel(src: torch.Tensor, src_mask: torch.Tensor, dst: torch.Tensor,
               dst_mask: torch.Tensor, normals: Optional[torch.Tensor],
               cov_src: Optional[torch.Tensor],
               cov_dst: Optional[torch.Tensor], init_T: torch.Tensor,
               max_iterations: int, mode: str, max_corr: float = 1.0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-shape registration (JAX ``_icp_kernel``,
    verification.py:117-193), mode ∈ {"p2p", "p2l", "gicp"}. Returns
    (T, fitness, inlier_rmse) as tensors on the inputs' device."""
    dev, f32 = src.device, torch.float32
    n_src = src_mask.sum().clamp(min=1).to(f32)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def correspondences(T):
        moved = _transform(T, src)
        d2 = torch.where(dst_mask[None, :], _pairwise_d2(moved, dst),
                         torch.inf)
        j = torch.argmin(d2, dim=1)
        dist = torch.sqrt(d2.gather(1, j[:, None])[:, 0])
        w = src_mask & (dist <= max_corr)
        return moved, j, dist, w.to(f32)

    def p2p_step(T):
        _, j, _, w = correspondences(T)
        q = dst[j]
        sw = w.sum().clamp(min=1e-6)
        # weighted Kabsch from the ORIGINAL source to the matched targets
        p_c = (src * w[:, None]).sum(0) / sw
        q_c = (q * w[:, None]).sum(0) / sw
        H = torch.einsum("ni,nj->ij", (src - p_c) * w[:, None], q - q_c)
        U, _, Vt = torch.linalg.svd(H)
        d = torch.sign(torch.linalg.det(Vt.T @ U.T))
        D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                    d]))
        R = Vt.T @ D @ U.T
        Tn = torch.eye(4, dtype=f32, device=dev)
        Tn[:3, :3] = R
        Tn[:3, 3] = q_c - R @ p_c
        return Tn

    def p2l_step(T):
        moved, j, _, w = correspondences(T)
        q, n = dst[j], normals[j]
        r = ((moved - q) * n).sum(dim=1)               # signed plane residual
        J = torch.cat([torch.linalg.cross(moved, n), n], dim=1)   # (P, 6)
        Jw = J * w[:, None]
        A = Jw.T @ J + 1e-6 * eye6
        b = -Jw.T @ r
        return se3_exp(torch.linalg.solve(A, b)) @ T

    def gicp_step(T):
        """Gauss-Newton on rᵀ (C_q + R C_p Rᵀ)⁻¹ r."""
        moved, j, _, w = correspondences(T)
        q = dst[j]
        R = T[:3, :3]
        Cs = torch.einsum("ab,pbc,dc->pad", R, cov_src, R)
        M = torch.linalg.inv(cov_dst[j] + Cs + 1e-9 * eye3)      # (P, 3, 3)
        r = moved - q
        x, y, z = moved[:, 0], moved[:, 1], moved[:, 2]
        zero = torch.zeros_like(x)
        # J = [ -[moved]ₓ | I ] per point, (P, 3, 6)
        Jr = torch.stack([torch.stack([zero, z, -y], dim=-1),
                          torch.stack([-z, zero, x], dim=-1),
                          torch.stack([y, -x, zero], dim=-1)], dim=1)
        J = torch.cat([Jr, eye3.expand_as(Jr)], dim=2)
        MJ = torch.einsum("pij,pjb->pib", M, J)
        A = torch.einsum("p,pia,pib->ab", w, J, MJ) + 1e-9 * eye6
        b = -torch.einsum("p,pib,pi->b", w, MJ, r)
        return se3_exp(torch.linalg.solve(A, b)) @ T

    step = {"p2p": p2p_step, "p2l": p2l_step, "gicp": gicp_step}[mode]
    T = init_T
    for _ in range(max_iterations):
        T = step(T)
    _, _, dist, w = correspondences(T)
    inliers = w.sum()
    fitness = inliers / n_src
    rmse = torch.sqrt((w * dist ** 2).sum() / inliers.clamp(min=1e-6))
    return T, fitness, rmse


class PreparedCloud:
    """Per-cloud verification state, computed once per cloud: the
    downsampled points plus the GICP covariances or point-to-plane normals
    (and, for the torch backend, the padded device tensors)."""

    __slots__ = ("pts", "cov", "normals", "padded", "mask")

    def __init__(self, pts, cov=None, normals=None, padded=None, mask=None):
        self.pts = pts
        self.cov = cov
        self.normals = normals
        self.padded = padded
        self.mask = mask


class GeometricVerifier:
    """``verify(source, target)`` → (verified, transform or None, info);
    either side may be raw (N, 3|4) points or a :class:`PreparedCloud`
    from :meth:`prepare`."""

    def __init__(self, method: str = "gicp", fitness_threshold: float = 0.3,
                 rmse_threshold: float = 0.5, max_iterations: int = 30,
                 voxel_downsample: float = 0.3,
                 max_correspondence_distance: float = 1.0,
                 max_points: int = 4096, backend: str = "auto",
                 gicp_epsilon: float = 1e-3, covariance_knn: int = 20,
                 device: DeviceLike = "cuda"):
        if method not in ("icp", "point_to_plane", "gicp"):
            raise ValueError(f"unknown verification method: {method}")
        self.method = method
        self.gicp_epsilon = gicp_epsilon
        self.covariance_knn = covariance_knn
        self.fitness_threshold = fitness_threshold
        self.rmse_threshold = rmse_threshold
        self.max_iterations = max_iterations
        self.voxel_downsample = voxel_downsample
        self.max_correspondence_distance = max_correspondence_distance
        self.max_points = max_points
        # "auto" is the native library, built here: a failed build raises
        backend = {"auto": "native", "jax": "torch"}.get(backend, backend)
        if backend not in ("native", "torch"):
            raise ValueError(f"unknown verifier backend: {backend}")
        if backend == "native":
            from neural_spectral_codec_torch.native import geom
            geom.load()
        self.backend = backend
        self.device = (resolve_device(device) if self.backend == "torch"
                       else torch.device("cpu"))
        logger.info("geometric verifier: %s backend, %s, %d points",
                    self.backend, method, max_points)

    def prepare(self, points: np.ndarray) -> PreparedCloud:
        """Downsample the cloud and compute its covariances or normals."""
        if self.backend == "native":
            from neural_spectral_codec_torch.native import geom
            pts = geom.voxel_downsample(points, self.voxel_downsample)
            if len(pts) > self.max_points:
                pts = pts[np.linspace(0, len(pts) - 1,
                                      self.max_points).astype(int)]
            cov = normals = None
            if len(pts) >= 6:
                cell = 2 * self.voxel_downsample
                if self.method == "gicp":
                    cov = geom.estimate_covariances(
                        pts, k=self.covariance_knn, grid_cell=cell,
                        eps=self.gicp_epsilon)
                elif self.method == "point_to_plane":
                    normals = geom.estimate_normals(pts, k=16,
                                                    grid_cell=cell)
            return PreparedCloud(pts, cov=cov, normals=normals)

        pts = voxel_downsample(points, self.voxel_downsample)
        padded, mask = _pad(pts, self.max_points)
        p = torch.from_numpy(padded).to(self.device)
        m = torch.from_numpy(mask).to(self.device)
        cov = normals = None
        with torch.no_grad():
            if self.method == "gicp":
                cov = knn_covariances(p, m, self.covariance_knn,
                                      self.gicp_epsilon)
            elif self.method == "point_to_plane":
                normals = knn_normals(p, m)
        return PreparedCloud(pts, cov=cov, normals=normals, padded=p, mask=m)

    def _prep(self, points_or_prepared) -> PreparedCloud:
        if isinstance(points_or_prepared, PreparedCloud):
            return points_or_prepared
        return self.prepare(points_or_prepared)

    def verify(self, source_points, target_points,
               initial_transform: Optional[np.ndarray] = None
               ) -> Tuple[bool, Optional[np.ndarray], Dict]:
        sprep = self._prep(source_points)
        dprep = self._prep(target_points)
        if self.backend == "native":
            T, fitness, rmse = self._register_native(sprep, dprep,
                                                     initial_transform)
        else:
            T, fitness, rmse = self._register_torch(sprep, dprep,
                                                    initial_transform)
        info = {"fitness": fitness, "rmse": rmse,
                "information_matrix": self._information_matrix(fitness)}
        if T is None:
            return False, None, info
        verified = (fitness >= self.fitness_threshold
                    and rmse <= self.rmse_threshold)
        return (True, T, info) if verified else (False, None, info)

    def _register_native(self, sprep, dprep, initial_transform):
        from neural_spectral_codec_torch.native import geom
        src, dst = sprep.pts, dprep.pts
        if len(src) < 6 or len(dst) < 6:
            return None, 0.0, float("inf")
        if self.method == "gicp":
            return geom.gicp(src, dst, sprep.cov, dprep.cov,
                             init=initial_transform,
                             max_iterations=self.max_iterations,
                             max_correspondence=
                             self.max_correspondence_distance)
        return geom.icp(src, dst, normals=dprep.normals,
                        init=initial_transform,
                        max_iterations=self.max_iterations,
                        max_correspondence=self.max_correspondence_distance)

    def _register_torch(self, sprep, dprep, initial_transform):
        init = (np.eye(4, dtype=np.float32) if initial_transform is None
                else np.asarray(initial_transform, np.float32))
        mode = {"icp": "p2p", "point_to_plane": "p2l",
                "gicp": "gicp"}[self.method]
        with torch.no_grad():
            T, fitness, rmse = icp_kernel(
                sprep.padded, sprep.mask, dprep.padded, dprep.mask,
                dprep.normals, sprep.cov, dprep.cov,
                torch.from_numpy(init).to(self.device), self.max_iterations,
                mode, self.max_correspondence_distance)
            out = torch.cat([T.reshape(-1), fitness[None], rmse[None]]
                            ).cpu().numpy()                    # one fetch
        return (out[:16].reshape(4, 4).astype(np.float64), float(out[16]),
                float(out[17]))

    @staticmethod
    def _information_matrix(fitness: float) -> np.ndarray:
        """Diagonal heuristic scaled by fitness: 100 for translation,
        1000 for rotation."""
        info = np.eye(6)
        info[:3, :3] *= 100.0 * fitness
        info[3:, 3:] *= 1000.0 * fitness
        return info


def verify_loop_closure(source_points, target_points, method: str = "gicp",
                        fitness_threshold: float = 0.3,
                        rmse_threshold: float = 0.5,
                        backend: str = "auto", device: DeviceLike = "cuda"):
    """One verification with a fresh verifier."""
    return GeometricVerifier(
        method=method, fitness_threshold=fitness_threshold,
        rmse_threshold=rmse_threshold, backend=backend,
        device=device).verify(source_points, target_points)


def batch_verify_candidates(query_points, candidate_points_list,
                            method: str = "gicp",
                            fitness_threshold: float = 0.3,
                            rmse_threshold: float = 0.5,
                            parallel: bool = False,
                            max_workers: int = 4, backend: str = "auto",
                            device: DeviceLike = "cuda") -> list:
    """Verify many candidates against one query, in input order; with
    ``parallel`` and the native backend, in a thread pool."""
    v = GeometricVerifier(method=method, fitness_threshold=fitness_threshold,
                          rmse_threshold=rmse_threshold, backend=backend,
                          device=device)
    qprep = v.prepare(query_points)
    if parallel and v.backend == "native" and len(candidate_points_list) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(lambda c: v.verify(qprep, c),
                                 candidate_points_list))
    return [v.verify(qprep, c) for c in candidate_points_list]
