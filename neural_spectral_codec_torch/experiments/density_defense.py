"""Descriptor error and retrieval recall against the point budget on
ray-cast scenes: the port of ``experiments/density_defense.py``.

    python -m neural_spectral_codec_torch.experiments.density_defense \\
        [--scenes 8] [--strides 1 2 4 5 8] [--device cuda] [--json out.json]

Structured scenes (ground plane and boxes) are ray-cast at the full
HDL-64E grid (64 × 2088 = 133,632 rays, 2 cm range noise, 8% dropout)
and decimated by azimuth stride. For each stride: the largest descriptor
difference from full density and W₁ to it, beside the encoder's own
scales (W₁ under a z-rotation, a same-place re-observation, and between
different places); then Recall@{1,5,10} of stage-1 W₁ ranking on two
loops of 90 scans around one ray-cast world at strides 1 and 4, and decimated queries against the full-density database. The
JAX script writes its table to docs/; this one prints it and writes
``--json``.

The boxes are intersected on ``--device`` in float64 (``raycast``): the
same operations as the JAX script's numpy, so the scans are the same
bits; the random draws stay on the host, in the script's order. The
descriptors come from ``encode_points_batch`` (the projection and
spectral kernels on a card).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device

N_ELEV, N_AZIM_FULL = 64, 2088          # HDL-64E: 64 lasers x ~0.172 deg
ELEV = np.deg2rad(np.linspace(-24.8, 2.0, N_ELEV, endpoint=False)
                  + 26.8 / N_ELEV / 2)
SENSOR_Z = 1.73                          # KITTI mount height
BOX_CHUNK = 16                           # boxes intersected at once
ENCODE_CHUNK = 32                        # scans encoded at once


def _boxes(centers: np.ndarray, rng):
    sizes = np.stack([rng.uniform(2, 20, len(centers)),
                      rng.uniform(2, 20, len(centers)),
                      rng.uniform(2, 12, len(centers))], axis=1)
    lo = np.concatenate([centers - sizes[:, :2] / 2,
                         np.zeros((len(centers), 1)) - SENSOR_Z], axis=1)
    hi = np.concatenate([centers + sizes[:, :2] / 2,
                         sizes[:, 2:] - SENSOR_Z], axis=1)
    return lo.astype(np.float32), hi.astype(np.float32)


def make_scene(rng, n_boxes: int = 40):
    """Axis-aligned boxes (buildings, cars) around the sensor, none
    within 6 m (copied from the JAX script)."""
    centers = rng.uniform(-60, 60, (n_boxes, 2))
    return _boxes(centers[np.linalg.norm(centers, axis=1) > 6.0], rng)


def make_world_for_loop(rng, radius: float, n_boxes: int = 120,
                        extent: float = 160.0):
    """Boxes over the area of a circular trajectory of ``radius``, none
    closer than 6 m to the path (copied from the JAX script)."""
    centers = rng.uniform(-extent, extent, (n_boxes, 2))
    dist_to_path = np.abs(np.linalg.norm(centers, axis=1) - radius)
    return _boxes(centers[dist_to_path > 6.0], rng)


def raycast(lo, hi, yaw: float, rng, pos=(0.0, 0.0),
            device: DeviceLike = "cuda") -> np.ndarray:
    """The 64 × N_AZIM_FULL ray grid from ``pos``, rotated by ``yaw``
    → (rays, 4) float32 points with 2 cm range noise, 8% dropout and NaN
    for misses. Ray directions, the draws and the gates run on the host
    as in the JAX script; the ground plane and the box slab tests in
    float64 on ``device`` (the nearest hit over the boxes, exact like
    the script's sequential minimum)."""
    lo = lo - np.array([pos[0], pos[1], 0.0], np.float32)
    hi = hi - np.array([pos[0], pos[1], 0.0], np.float32)
    az = (np.linspace(-np.pi, np.pi, N_AZIM_FULL, endpoint=False)[None, :]
          + yaw)
    el = ELEV[:, None]
    d = np.stack(np.broadcast_arrays(
        np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
        np.sin(el) * np.ones_like(az)), axis=-1).reshape(-1, 3)

    device = resolve_device(device)
    dt = torch.from_numpy(d).to(device)
    dz = dt[:, 2]
    down = dz < -1e-6
    tg = torch.where(down, -SENSOR_Z / torch.where(down, dz, -1.0),
                     torch.inf)
    t_best = tg
    inv = 1.0 / torch.where(dt.abs() > 1e-9, dt, 1e-9)
    lo_t = torch.from_numpy(lo).to(device).double()
    hi_t = torch.from_numpy(hi).to(device).double()
    for s in range(0, len(lo), BOX_CHUNK):
        t0 = lo_t[s:s + BOX_CHUNK, None, :] * inv
        t1 = hi_t[s:s + BOX_CHUNK, None, :] * inv
        tmin = torch.minimum(t0, t1).amax(dim=2)
        tmax = torch.maximum(t0, t1).amin(dim=2)
        hit = (tmax >= tmin) & (tmax > 0)
        t_hit = torch.where(tmin > 0, tmin, tmax)
        t_best = torch.minimum(
            t_best, torch.where(hit, t_hit, torch.inf).amin(dim=0))
    t_best = t_best.cpu().numpy()

    t_best = t_best + rng.normal(0, 0.02, len(t_best)).astype(np.float32)
    pts = d * t_best[:, None]
    drop = rng.random(len(pts)) < 0.08
    bad = drop | ~np.isfinite(t_best) | (t_best > 80) | (t_best < 1)
    pts = np.concatenate(
        [pts, rng.random((len(pts), 1)).astype(np.float32)], axis=1)
    pts[bad] = np.nan
    return pts.astype(np.float32)


def _encoder(device):
    """(clouds, budget) → descriptors: ``SpectralEncoder`` at that point
    budget, ENCODE_CHUNK clouds a device batch."""
    from neural_spectral_codec_torch.ops.spectral import SpectralEncoder

    def encode(pts_list, budget: int) -> np.ndarray:
        enc = SpectralEncoder(max_points=budget, device=device)
        return np.concatenate([enc(pts_list[s:s + ENCODE_CHUNK]) for s in
                               range(0, len(pts_list), ENCODE_CHUNK)])
    return encode


def recall_at_strides(strides: Sequence[int], rng, encode, w1_matrix,
                      device: DeviceLike = "cuda", n_per_loop: int = 90,
                      radius: float = 60.0, skip_frames: int = 30,
                      geo_threshold: float = 5.0,
                      top_ks: Sequence[int] = (1, 5, 10)):
    """Recall@K of stage-1 W₁ ranking per stride on two loops around one
    ray-cast world (the second loop revisits the first with fresh noise
    and heading jitter), and for stride s ≠ 1 the decimated queries
    against the full-density database: ({(mode, s): {k: r}}, queries).
    The JAX script's protocol."""
    lo, hi = make_world_for_loop(rng, radius)
    n = 2 * n_per_loop
    theta = np.linspace(0, 4 * np.pi, n, endpoint=False)
    positions = np.stack([radius * np.cos(theta), radius * np.sin(theta),
                          np.zeros(n)], axis=1)
    scans = []
    for i in range(n):
        yaw = theta[i] + np.pi / 2 + rng.normal(0, 0.03)
        scans.append(raycast(lo, hi, yaw, rng,
                             pos=(positions[i, 0], positions[i, 1]),
                             device=device))

    full = N_ELEV * N_AZIM_FULL
    gap = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    geo = np.linalg.norm(positions[:, None, :] - positions[None, :, :],
                         axis=2)
    has_rev = ((gap > skip_frames) & (geo < geo_threshold)).any(axis=1)
    queries = np.where(has_rev)[0]

    def protocol_recall(d_query, d_db):
        dist = w1_matrix(d_query[queries], d_db)
        dist = np.where(gap[queries] > skip_frames, dist, np.inf)
        order = np.argsort(dist, axis=1)
        return {k: float((geo[queries[:, None], order[:, :k]]
                          < geo_threshold).any(axis=1).mean())
                for k in top_ks}

    descs = {s: encode([p[::s] for p in scans], -(-full // s))
             for s in strides}
    results = {}
    for s in strides:
        results[("pure", s)] = protocol_recall(descs[s], descs[s])
        if s != 1:
            results[("mixed", s)] = protocol_recall(descs[s], descs[1])
    return results, len(queries)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--strides", type=int, nargs="+", default=[1, 2, 4, 5, 8])
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    from neural_spectral_codec_torch.ops.wasserstein import (
        wasserstein_1d, wasserstein_matrix)
    device = resolve_device(args.device)
    encode = _encoder(device)
    rng = np.random.default_rng(11)
    n_scenes, strides = args.scenes, args.strides
    full = N_ELEV * N_AZIM_FULL

    scenes = [make_scene(rng) for _ in range(n_scenes)]
    scans = [raycast(lo, hi, 0.0, rng, device=device) for lo, hi in scenes]
    rot_scans = [raycast(lo, hi, rng.uniform(0, 2 * np.pi), rng,
                         device=device) for lo, hi in scenes]
    reobs = [raycast(lo, hi, rng.normal(0, 0.02), rng, device=device)
             for lo, hi in scenes]
    d_full = encode(scans, full)
    d_rot = encode(rot_scans, full)
    d_reobs = encode(reobs, full)

    def w1(a, b):
        return float(wasserstein_1d(torch.from_numpy(a), torch.from_numpy(b)))

    rot_jitter = [w1(d_full[i], d_rot[i]) for i in range(n_scenes)]
    reobs_dist = [w1(d_full[i], d_reobs[i]) for i in range(n_scenes)]
    inter = [w1(d_full[i], d_full[j])
             for i in range(n_scenes) for j in range(i + 1, n_scenes)]
    rows = []
    for s in strides[1:]:
        budget = -(-full // s)
        d_b = encode([p[::s] for p in scans], budget)
        w1s = [w1(d_b[i], d_full[i]) for i in range(n_scenes)]
        rows.append({"stride": s, "points": budget,
                     "max_abs_desc_err": float(np.abs(d_b - d_full).max()),
                     "w1_mean": float(np.mean(w1s)),
                     "w1_max": float(np.max(w1s))})
        print(f"stride {s} (N={budget:6d}): max|dDesc|="
              f"{rows[-1]['max_abs_desc_err']:.2e} W1 mean="
              f"{np.mean(w1s):.4f} max={np.max(w1s):.4f}")
    scales = {"rotation_jitter_w1": rot_jitter,
              "reobservation_w1": reobs_dist, "different_places_w1": inter}
    print(f"rotation jitter   W1: mean={np.mean(rot_jitter):.4f} "
          f"max={np.max(rot_jitter):.4f}")
    print(f"re-observation    W1: mean={np.mean(reobs_dist):.4f} "
          f"max={np.max(reobs_dist):.4f}")
    print(f"different places  W1: mean={np.mean(inter):.4f} "
          f"min={np.min(inter):.4f}")

    def w1_matrix(a, b):
        return wasserstein_matrix(torch.from_numpy(a).to(device),
                                  torch.from_numpy(b).to(device)
                                  ).cpu().numpy()
    recall, n_queries = recall_at_strides(
        [1, 4], np.random.default_rng(7), encode, w1_matrix, device=device)
    for (mode, s), r in sorted(recall.items()):
        print(f"recall[{mode} stride {s}] ({n_queries} queries): "
              + "  ".join(f"R@{k} {v:.4f}" for k, v in r.items()))
    out = {"device": str(device), "scenes": n_scenes, "strides": rows,
           "scales": scales, "recall_queries": n_queries,
           "recall": {f"{mode}_stride{s}": {str(k): v for k, v in r.items()}
                      for (mode, s), r in recall.items()}}
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
