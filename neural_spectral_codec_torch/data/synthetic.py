"""Synthetic looping trajectories and scans of a procedural world, for
training and loop-closure recall without a dataset on disk. Copied from
``neural_spectral_codec_tpu/data/synthetic.py`` (numpy; importing the JAX
package imports jax), so the same seed gives the same stream.

World model: a field of vertical cylinders on a position-hashed grid; a
scan samples cylinder surfaces near the pose and moves them into the
sensor frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def loop_trajectory(n_frames: int, radius: float = 120.0, loops: float = 2.0,
                    speed: float = 1.0, dt: float = 0.1) -> np.ndarray:
    """(n, 4, 4) poses driving ``loops`` times around a circle; with
    ``n_frames`` divisible by ``loops`` every lap lands on lap 1's poses."""
    theta = np.linspace(0, 2 * np.pi * loops, n_frames, endpoint=False)
    x, y = radius * np.cos(theta), radius * np.sin(theta)
    yaw = theta + np.pi / 2
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    poses[:, 0, 3], poses[:, 1, 3] = x, y
    c, s = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0], poses[:, 0, 1] = c, -s
    poses[:, 1, 0], poses[:, 1, 1] = s, c
    return poses


class SyntheticWorld:
    """Deterministic cylinder field: position-hashed landmarks on a grid,
    so scans from nearby poses see the same geometry."""

    def __init__(self, seed: int = 0, cell: float = 12.0,
                 density: float = 0.55):
        self.seed = seed
        self.cell = cell
        self.density = density

    def _cell_landmark(self, ci: np.ndarray, cj: np.ndarray):
        h = (ci.astype(np.int64) * 73856093) \
            ^ (cj.astype(np.int64) * 19349663) ^ self.seed
        h = (h ^ (h >> 13)) * 0x5BD1E995
        h = (h ^ (h >> 15)) & 0x7FFFFFFF
        u0 = ((h % 10007) / 10007.0)
        u1 = (((h // 10007) % 10007) / 10007.0)
        u2 = (((h // 1009) % 1009) / 1009.0)
        present = u0 < self.density
        cx = (ci + 0.15 + 0.7 * u1) * self.cell
        cy = (cj + 0.15 + 0.7 * u2) * self.cell
        radius = 0.5 + 1.5 * u0 / max(self.density, 1e-6)
        height = 3.0 + 10.0 * u1
        return present, cx, cy, radius, height

    def scan(self, pose: np.ndarray, n_points: int = 16384,
             max_range: float = 70.0,
             rng: Optional[np.random.Generator] = None,
             noise: float = 0.02) -> np.ndarray:
        """Sensor-frame (n, 4) float32 [x, y, z, intensity] points on the
        cylinders within ``max_range`` of ``pose``."""
        rng = rng or np.random.default_rng(0)
        px, py = pose[0, 3], pose[1, 3]
        reach = int(np.ceil(max_range / self.cell))
        ci0, cj0 = int(np.floor(px / self.cell)), int(np.floor(py / self.cell))
        ci, cj = np.meshgrid(np.arange(ci0 - reach, ci0 + reach + 1),
                             np.arange(cj0 - reach, cj0 + reach + 1),
                             indexing="ij")
        present, cx, cy, radius, height = self._cell_landmark(ci.ravel(),
                                                              cj.ravel())
        cx, cy = cx[present], cy[present]
        radius, height = radius[present], height[present]
        if len(cx) == 0:
            return np.zeros((0, 4), dtype=np.float32)
        # points per cylinder in proportion to 1 / distance
        d = np.hypot(cx - px, cy - py) + 1e-6
        w = np.clip(1.0 / d, 0, 1)
        w /= w.sum()
        pick = rng.choice(len(cx), n_points, p=w)
        ang = rng.uniform(0, 2 * np.pi, n_points)
        zz = rng.uniform(0.0, height[pick]) - 1.7  # sensor 1.7 m up
        wx = cx[pick] + radius[pick] * np.cos(ang)
        wy = cy[pick] + radius[pick] * np.sin(ang)
        world = np.stack([wx, wy, zz], axis=1)
        world += rng.normal(0, noise, world.shape)
        R, t = pose[:3, :3], pose[:3, 3]
        local = (world - t) @ R                    # R^T (p_world − t)
        rr = np.linalg.norm(local, axis=1)
        keep = rr <= max_range
        local = local[keep]
        inten = np.clip(1.0 - rr[keep] / max_range, 0, 1)
        return np.column_stack([local, inten]).astype(np.float32)


class SyntheticLoader:
    """Loader over a synthetic looping trajectory, with the item dict of
    the dataset loaders (points, pose, timestamp, idx). Deterministic
    given ``seed``."""

    def __init__(self, n_frames: int = 200, seed: int = 0,
                 n_points: int = 16384, radius: float = 120.0,
                 loops: float = 2.0):
        self.num_frames = n_frames
        self.seed = seed
        self.n_points = n_points
        self.poses = loop_trajectory(n_frames, radius=radius, loops=loops)
        self.timestamps = np.arange(n_frames) * 0.1
        self.world = SyntheticWorld(seed=seed)

    def __len__(self) -> int:
        return self.num_frames

    def __getitem__(self, idx: int) -> dict:
        if idx < 0 or idx >= self.num_frames:
            raise IndexError(idx)
        rng = np.random.default_rng(self.seed * 100003 + idx)
        pts = self.world.scan(self.poses[idx], n_points=self.n_points,
                              rng=rng)
        return {"points": pts, "pose": self.poses[idx],
                "timestamp": self.timestamps[idx], "idx": idx}


def beam_elevations(n_beams: int, beam_fov_deg=(-24.8, 2.0)) -> np.ndarray:
    """Elevation angles (radians, increasing) of ``n_beams`` evenly spaced
    beams over the vertical field of view."""
    return np.radians(np.linspace(beam_fov_deg[0], beam_fov_deg[1], n_beams))


def snap_to_beams(points: np.ndarray, n_beams: int,
                  beam_fov_deg=(-24.8, 2.0)) -> np.ndarray:
    """Simulate an ``n_beams``-beam spinning LiDAR from a dense cloud: snap
    each point's elevation to the nearest beam (range and azimuth kept) and
    drop points outside the vertical field of view."""
    pts = np.asarray(points)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rho = np.sqrt(x * x + y * y)
    el = np.arctan2(z, rho)
    beams = beam_elevations(n_beams, beam_fov_deg)
    snapped = beams[np.abs(el[:, None] - beams[None, :]).argmin(axis=1)]
    keep = (el >= beams[0] - 0.01) & (el <= beams[-1] + 0.01)
    out = pts.copy()
    out[:, 2] = rho * np.tan(snapped)
    return out[keep]


def wedge_dropout_keep(pts: np.ndarray, rng: np.random.Generator,
                       wedge_deg: Optional[float], dropout: float,
                       dropout_first: bool = False) -> np.ndarray:
    """Keep mask of a random azimuth wedge (when ``wedge_deg`` is set)
    minus random point dropout; ``dropout_first`` fixes the order of the
    two draws (the loaders' recorded streams depend on it)."""
    keep = np.ones(len(pts), dtype=bool)
    if dropout_first:
        keep &= rng.random(len(pts)) >= dropout
    if wedge_deg is not None:
        az = np.arctan2(pts[:, 1], pts[:, 0])
        center = rng.uniform(-np.pi, np.pi)
        delta = np.abs(np.angle(np.exp(1j * (az - center))))
        keep &= delta < np.deg2rad(wedge_deg / 2)
    if not dropout_first:
        keep &= rng.random(len(pts)) > dropout
    return keep


class SensorSimLoader(SyntheticLoader):
    """Synthetic loader through a simulated ``n_beams``-beam sensor
    (snap-to-beam and vertical field-of-view crop), with optional azimuth
    wedge and point dropout.

    ``sweep_order`` (not in the JAX package; off by default, which keeps
    the JAX stream) emits each scan in a spinning sensor's order:
    ring-major from the lowest beam up, azimuth increasing within a ring,
    as a KITTI ``.bin`` file is ordered. Only the order of the points
    changes, not the points, so the descriptor is the same;
    ``encoding.ring_major`` can then take the ring path."""

    def __init__(self, *args, n_beams: int = 16,
                 beam_fov_deg=(-15.0, 15.0),
                 wedge_deg: Optional[float] = None, dropout: float = 0.0,
                 sweep_order: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_beams = n_beams
        self.beam_fov_deg = tuple(beam_fov_deg)
        self.wedge_deg = wedge_deg
        self.dropout = dropout
        self.sweep_order = sweep_order

    def __getitem__(self, idx: int) -> dict:
        item = super().__getitem__(idx)
        pts = snap_to_beams(item["points"], self.n_beams, self.beam_fov_deg)
        if self.wedge_deg is not None or self.dropout > 0.0:
            rng = np.random.default_rng(hash((self.seed, idx, 911)) % (2**31))
            pts = pts[wedge_dropout_keep(pts, rng, self.wedge_deg,
                                         self.dropout, dropout_first=True)]
        if self.sweep_order:
            beams = beam_elevations(self.n_beams, self.beam_fov_deg)
            el = np.arctan2(pts[:, 2], np.hypot(pts[:, 0], pts[:, 1]))
            beam = np.abs(el[:, None] - beams[None, :]).argmin(axis=1)
            pts = pts[np.lexsort((np.arctan2(pts[:, 1], pts[:, 0]), beam))]
        item["points"] = pts
        return item


class DegradedSyntheticLoader(SyntheticLoader):
    """Synthetic loader whose scans each keep a random azimuth wedge and
    lose random points (JAX ``DegradedSyntheticLoader``, synthetic.py:212):
    a revisit sees another wedge of the same place. Deterministic per
    (seed, frame); the seed derivation and the draw order (wedge centre
    first) are JAX's, so the frames are byte-equal to the JAX stream."""

    def __init__(self, *args, wedge_deg: float = 200.0,
                 dropout: float = 0.3, **kwargs):
        super().__init__(*args, **kwargs)
        self.wedge_deg = wedge_deg
        self.dropout = dropout

    def __getitem__(self, idx: int) -> dict:
        item = super().__getitem__(idx)
        pts = item["points"]
        rng = np.random.default_rng(hash((self.seed, idx, 77)) % (2 ** 31))
        item["points"] = pts[wedge_dropout_keep(pts, rng, self.wedge_deg,
                                                self.dropout)]
        return item
