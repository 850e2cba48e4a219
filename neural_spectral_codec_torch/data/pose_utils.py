"""SE(3) pose math, host-side numpy. Copied from
``neural_spectral_codec_tpu/data/pose_utils.py`` (and the quaternion
helpers of ``ops/quantization.py:101-155``): importing the JAX package
imports jax. Single-pose functions take (4, 4) matrices; the ``*_batch``
variants are vectorised over leading axes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def matrix_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → unit quaternion [w, x, y, z] (Shepperd's
    method), sign canonicalised to w ≥ 0."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z], dtype=np.float64)
    return -q if q[0] < 0 else q


def quat_wxyz_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def pose_to_7dof(pose: np.ndarray) -> np.ndarray:
    """(4, 4) SE(3) → [x, y, z, qw, qx, qy, qz]."""
    return np.concatenate([pose[:3, 3], matrix_to_quat_wxyz(pose[:3, :3])])


def pose_from_7dof(p7: np.ndarray) -> np.ndarray:
    """[x, y, z, qw, qx, qy, qz] → (4, 4) SE(3)."""
    T = np.eye(4)
    T[:3, :3] = quat_wxyz_to_matrix(np.asarray(p7[3:], dtype=np.float64))
    T[:3, 3] = p7[:3]
    return T


def pose_to_transformation_matrix(position: np.ndarray,
                                  rotation: np.ndarray) -> np.ndarray:
    """[x, y, z] + a (3, 3) matrix or a [w, x, y, z] quaternion → SE(3)."""
    T = np.eye(4)
    T[:3, 3] = position
    if rotation.shape == (3, 3):
        T[:3, :3] = rotation
    elif rotation.shape == (4,):
        T[:3, :3] = quat_wxyz_to_matrix(rotation)
    else:
        raise ValueError(f"Invalid rotation shape: {rotation.shape}")
    return T


def transformation_matrix_to_pose(T: np.ndarray
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    return T[:3, 3], T[:3, :3]


def inverse_pose(T: np.ndarray) -> np.ndarray:
    """Closed-form SE(3) inverse; works batched over (..., 4, 4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = np.swapaxes(R, -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def compose_poses(T1: np.ndarray, T2: np.ndarray) -> np.ndarray:
    return T1 @ T2


def relative_pose(T_source: np.ndarray, T_target: np.ndarray) -> np.ndarray:
    """T_source⁻¹ @ T_target."""
    return inverse_pose(T_source) @ T_target


def transform_points(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Rigid transform of (N, 3|4) points; intensity passes through."""
    out_xyz = points[:, :3] @ T[:3, :3].T + T[:3, 3]
    if points.shape[1] == 3:
        return out_xyz
    if points.shape[1] == 4:
        return np.hstack([out_xyz, points[:, 3:4]])
    raise ValueError(f"Invalid point cloud shape: {points.shape}")


def euclidean_distance(T1: np.ndarray, T2: np.ndarray) -> float:
    return float(np.linalg.norm(T2[:3, 3] - T1[:3, 3]))


def euclidean_distance_batch(poses1: np.ndarray,
                             poses2: np.ndarray) -> np.ndarray:
    """(..., 4, 4) × (..., 4, 4) → (...,) translation distances."""
    return np.linalg.norm(poses2[..., :3, 3] - poses1[..., :3, 3], axis=-1)


def rotation_angle(T1: np.ndarray, T2: np.ndarray) -> float:
    """Geodesic rotation angle (radians), from the trace."""
    R_rel = T1[:3, :3].T @ T2[:3, :3]
    cos_theta = np.clip((np.trace(R_rel) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.arccos(cos_theta))


def rotation_angle_batch(poses1: np.ndarray,
                         poses2: np.ndarray) -> np.ndarray:
    R_rel = np.einsum("...ji,...jk->...ik", poses1[..., :3, :3],
                      poses2[..., :3, :3])
    tr = np.trace(R_rel, axis1=-2, axis2=-1)
    return np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))


def rotation_angle_degrees(T1: np.ndarray, T2: np.ndarray) -> float:
    return float(np.degrees(rotation_angle(T1, T2)))


def _slerp(q0: np.ndarray, q1: np.ndarray, alpha: float) -> np.ndarray:
    """Quaternion SLERP, [w, x, y, z], closed form."""
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1 = -q1
        dot = -dot
    dot = min(dot, 1.0)
    if dot > 0.9995:
        q = q0 + alpha * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(dot)
    s = np.sin(theta)
    return (np.sin((1 - alpha) * theta) * q0 + np.sin(alpha * theta) * q1) / s


def interpolate_poses(T1: np.ndarray, T2: np.ndarray,
                      alpha: float) -> np.ndarray:
    """LERP of the translation, SLERP of the rotation."""
    t = (1 - alpha) * T1[:3, 3] + alpha * T2[:3, 3]
    q = _slerp(matrix_to_quat_wxyz(T1[:3, :3]),
               matrix_to_quat_wxyz(T2[:3, :3]), alpha)
    T = np.eye(4)
    T[:3, :3] = quat_wxyz_to_matrix(q)
    T[:3, 3] = t
    return T


def pose_difference(T1: np.ndarray, T2: np.ndarray) -> Tuple[float, float]:
    return euclidean_distance(T1, T2), rotation_angle(T1, T2)


def is_valid_transformation(T: np.ndarray, epsilon: float = 1e-6) -> bool:
    """SE(3) validity: shape, bottom row, orthogonality, det = +1."""
    if T.shape != (4, 4):
        return False
    if not np.allclose(T[3, :], [0, 0, 0, 1], atol=epsilon):
        return False
    R = T[:3, :3]
    if not np.allclose(R @ R.T, np.eye(3), atol=epsilon):
        return False
    return bool(np.isclose(np.linalg.det(R), 1.0, atol=epsilon))


def cartesian_to_spherical(points: np.ndarray) -> np.ndarray:
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    return np.stack([r, np.arctan2(y, x),
                     np.arctan2(z, np.sqrt(x ** 2 + y ** 2))], axis=1)


def spherical_to_cartesian(spherical: np.ndarray) -> np.ndarray:
    r, az, el = spherical[:, 0], spherical[:, 1], spherical[:, 2]
    return np.stack([r * np.cos(el) * np.cos(az),
                     r * np.cos(el) * np.sin(az), r * np.sin(el)], axis=1)


def compute_overlap(points1: np.ndarray, points2: np.ndarray,
                    T_12: np.ndarray, voxel_size: float = 0.2,
                    max_points: int = 5000,
                    rng: Optional[np.random.Generator] = None,
                    backend: str = "numpy") -> float:
    """Voxel-IoU overlap of two clouds after downsampling to
    ``max_points`` each (JAX ``compute_overlap``, pose_utils.py:166).
    ``T_12`` maps cloud 2's frame into cloud 1's.

    ``backend="numpy"`` draws a random subsample from ``rng``;
    ``"native"`` runs the C++ hash grid (``native.geom.voxel_overlap``)
    on a fixed-stride subsample. Where the native library cannot be
    built, ``"native"`` raises (JAX's falls back to numpy)."""
    if backend == "native":
        from neural_spectral_codec_torch.native import geom
        return geom.voxel_overlap(points1, points2, T_12, voxel=voxel_size,
                                  max_points=max_points)
    if backend != "numpy":
        raise ValueError(f"unknown overlap backend: {backend!r}")
    rng = rng or np.random.default_rng(0)
    if len(points1) > max_points:
        points1 = points1[rng.choice(len(points1), max_points, replace=False)]
    if len(points2) > max_points:
        points2 = points2[rng.choice(len(points2), max_points, replace=False)]

    p2 = transform_points(points2[:, :3], T_12)

    def voxel_keys(pts: np.ndarray) -> np.ndarray:
        ok = np.isfinite(pts).all(axis=1)
        pts = np.clip(pts[ok], -1e6, 1e6)
        v = np.floor(pts / voxel_size).astype(np.int64)
        off = 1 << 20          # 3 × 21-bit signed coordinates in one int64
        key = ((v[:, 0] + off) << 42) | ((v[:, 1] + off) << 21) \
            | (v[:, 2] + off)
        return np.unique(key)

    k1, k2 = voxel_keys(points1[:, :3]), voxel_keys(p2)
    inter = np.intersect1d(k1, k2, assume_unique=True).size
    union = k1.size + k2.size - inter
    return inter / union if union > 0 else 0.0
