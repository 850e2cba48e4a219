#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths (``neural_spectral_codec_torch``) the way a user
would, at the full width of the model the repository supports, with
weights and data made from seeds:

1. device: requires a CUDA card and prints its name and power limit;
2. build: compiles the hand-written kernels from ``csrc/`` (one nvcc per
   source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the same
   CUDA tensors at its path's shapes. The serving kernels at 8
   full-density HDL-64E scans (133,632 points each) and on edge cases
   (drop mode, other fold counts, partial rows, no interpolation, points
   on bin edges and axes): the spectral kernel to <= 1e-5, the two
   projection kernels bit-equal (and equal to the plain path run on the
   CPU). The general projection kernel on scans in random order and in a
   sensor's sweep order (rings flattened ring-major, a NaN tail), each at
   B=1 and B=8. The probe kernels at the
   probe shapes (512 x 2176 keys, 512 x 768 and 512 x 2176 floors,
   512 x 2112 chain): the ring-fold probe bit-equal for n_folds 1-3 and,
   after the min over folds, equal to the ring kernel's image; every
   phase-ablation variant launches and gives finite rows; the ring-fold
   probe also bit-equal at B=1, on a single row, width 2175, rows off a
   16-byte boundary, all-invalid rows, rows that wrap at every point and
   the widest rows it takes, the next width refused; both roll kernels
   bit-equal (int32 views) there and in ROLL_CASES: windows shorter than
   the row, rows with NaN, ±0 and ±inf, widths 2175 and 2110, rows off a
   16-byte boundary, single rows; the three probes' device time also with
   a cold L2 (a 64 MB write before each launch, not counted), the
   ring-fold probe's also at B=1. The
   spectral kernel also at the serve shape (B=1),
   at E=16 (the training configuration) and E=20 (pooling windows that
   straddle CTAs), each with interpolation on and off and alpha 2.0 and
   1.3; the ring kernel also at B=1. One wrapper call of each serving
   kernel must enqueue its kernel and no other device operation
   (``torch.profiler``). Times (``utils/timing.py``), per
   kernel: its own device time (``torch.profiler`` kernel time by name
   over 50 wrapper calls, cross-checked by CUDA events around 200 bare
   C-entry launches queued behind a spin kernel), at B=8 and, for the
   three serving kernels, B=1 (the general projection kernel in both
   point orders); the wrapper's time per call (one event
   pair per call); the plain version's; and the bound (bytes at
   3.35 TB/s or fp32 operations at 67 TFLOP/s, from this run's shapes);
4. serve: a 1,000-node keyframe graph, a full-width SpectralGNN
   (800 -> 256 -> 800, 3 GAT layers), a 100,000-row W1 database on the
   card, and 32 requests through ``serve_step`` (16 ring-structured, 16
   arbitrary-order scans), top-10 with a spatial filter, query and insert
   on. Each request's scan also sits in the database as a row computed by
   the plain path on the CPU, outside the spatial filter; it must come
   back as top-1, the descriptor must agree with the CPU's to 1e-4 and
   the embeddings to 1e-3, and every serving kernel's launch count must
   rise;
5. probes: the two stage-profile entry points
   (``experiments.ring_stage_probe``, ``experiments.profile_hotpath``)
   with few iterations, each on its own: ring_stage_probe must launch the
   ring probe, the roll floor and the ring kernel, profile_hotpath the
   ring probe, the roll+min chain and the three serving kernels;
6. structured: ``encode_structured`` on four full-density flat streams
   (sweep order, firing-interleaved with and without a ring field, one
   unstructured); the first three must take the ring path and the last
   the general path, and each descriptor must be <= 1e-6 from
   ``encode_points_batch`` on the same cloud;
7. training: (a) one full-width train step (512 nodes, dropout 0, TF32
   off) on the card against the same step on the CPU from identical
   state, after hard-negative mining on both (the card's anchors and hard
   negatives must equal the CPU's): loss within 1e-4 relative, gradients
   within 1e-4 of each tensor's largest entry, parameters within 1e-4
   (except the gauge biases, whose true gradient is 0, and elements whose
   gradient is below 1e-3 of their tensor's largest, where Adam's update
   sign follows rounding); (b) the training entry point
   (``train_multi_dataset.main``, 120 synthetic frames, 2 epochs, a config
   dict with configs/training.yaml's values) once with the default encoder
   (``project`` and ``spectral`` must launch) and once with
   ``encoding.ring_major`` on 64-beam sweep-ordered sensor streams
   (``ring_fold`` and ``spectral`` must launch): finite losses, and the
   final checkpoint reloads to an equal state_dict; (c)
   ``experiments.scale_100k`` at 20,000 nodes: stage times, Recall@{1,5,10}
   and peak memory;
8. online: the online loop (``run_online`` through
   ``experiments.online_latency.run``) with configs/inference.yaml over
   default.yaml (built in code), full width (800-D descriptors, the
   SpectralGNN with random weights, 131,072 points a scan, top-10,
   context window 10, GICP at 30 iterations, 4,096 points and 0.3 m
   voxels, one-dispatch serving, async loop closing, 8 verification
   workers, warmup on), except the spatial filter (0), the synthetic
   stream in place of a dataset and a capacity of the map plus the
   session. It resumes a 100,000-record store written through the port's
   ``save_database`` (random ^4 histograms over 20 km, no points) and
   streams 200 pre-generated frames of two laps. Checks: loop closures on
   the second lap, each within the gates, in the g2o file; every
   descriptor within 1e-4 of the CPU plain encoder; the same edge set in
   the synchronous ``fused_query: false`` mode; the native and torch (on
   the card) verifier backends agree on the candidates of 10 queries;
   100,000 + keyframes rows, restored by a save/load round trip; ``project``
   and ``spectral`` launched. It prints per-keyframe latency p50/p95/max,
   keyframes over 100 ms, stage means, GICP ms per pair of each backend,
   warmup seconds, peak device memory, and (torch.profiler over a short
   fresh session) the device time and operations per keyframe.

Launch counts are set to 0 just before each path (4, each entry point of
5, 6, each entry-point run of 7, 8's one-dispatch run) and read just
after. Any failure raises
and the script exits nonzero, printing no result. Otherwise the line
before the last is the kernels' JSON record (launches per path and in
total, device, wrapper and plain times, bound, ``ms`` the wrapper's time
per call as earlier records held it, and ``library_ms`` null
with the reason: no single PyTorch call computes any kernel's function)
and the last is ``{"ok": true, "device": {...}}``. It needs no JAX.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SEED = 0
BATCH = 8                      # kernel-phase batch (bench.py's headline B)
N_RINGS, PER_RING = 64, 2088   # HDL-64E full density: 133,632 points
N_POINTS = N_RINGS * PER_RING
N_NODES = 1000
DB_ROWS = 100_000
N_REQUESTS = 32
TOP_K = 10
MIN_DIST = 10.0                # spatial filter radius (m)
TIMED_CALLS = 25

SPECTRAL_TOL = 1e-5            # kernel vs plain on the card
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
PROFILED_CALLS = 50
QUEUED_CALLS = 200
COLD_FLUSH_BYTES = 64 << 20    # written between launches: > the 50 MB L2
# roll-kernel cases beyond the probe shapes, (rows, width, stages, arrays,
# misaligned), arrays 0 = the P3 chain: windows shorter than the row (P2
# at 4, 8 and 6 stages, P3 at 5 and 16), saturated ones, rows with NaN, ±0
# and ±inf (``_special_rows``), widths that are not a multiple of 4, rows
# 4 bytes off a 16-byte boundary (the scalar loads), single rows
ROLL_CASES = (
    (512, 2176, 4, 2, False), (512, 2176, 8, 2, False),
    (512, 768, 6, 2, False), (512, 2176, 8, 1, False),
    (512, 2176, 12, 2, False), (512, 2176, 12, 1, False),
    (512, 2176, 40, 2, False), (64, 2175, 12, 2, False),
    (64, 2175, 11, 1, False), (64, 2176, 8, 2, True), (1, 2176, 12, 2, False),
    (1, 768, 6, 1, False),
    (512, 2112, 5, 0, False), (512, 2112, 16, 0, False),
    (512, 2112, 64, 0, False), (64, 2110, 16, 0, False),
    (64, 2110, 64, 0, False), (64, 2112, 16, 0, True),
    (1, 2112, 64, 0, False), (1, 2112, 16, 0, False),
)
# no single PyTorch call computes any kernel's whole function
NO_LIBRARY = {
    "spectral": "torch.fft.rfft covers one of six stages (interpolation, "
                "row fill, pooling, |DFT|, binning, sum-to-1)",
    "ring_fold": "per-point angle math, gates and the fold rule's min",
    "project": "per-point angle math and gates before the scatter-min",
    "ring_probe": "the fold rule's min over precomputed keys",
    "roll_floor": "the first minimum of a circular window with its "
                  "payload (argmin at the smallest forward offset, then "
                  "a[j] + b[j]); no PyTorch call takes a windowed argmin",
    "roll_min_chain": "torch.amin gives the saturated chain's row min, but "
                      "neither its + 1 nor its broadcast, nor a window "
                      "shorter than the row",
}
# kernel function names as torch.profiler reports them
KERNEL_NAMES = {
    "spectral": ("spectral_encode_kernel",),
    "ring_fold": ("ring_fold_kernel",),
    "project": ("project_points_kernel",),
    "ring_probe": ("ring_probe_kernel",),
    "roll_floor": ("roll_floor_kernel",),
    "roll_min_chain": ("roll_min_chain_kernel",),
}
DESC_TOL = 1e-4                # card vs CPU plain path (1-ulp atan2f cause)
EMB_TOL = 1e-3
TRAIN_TOL = 1e-4               # train step: card vs CPU
TRAIN_NODES = 512
SCALE_NODES = 20_000
STORE_ROWS = 100_000           # phase 8: the resumed map's records
ONLINE_FRAMES = 200            # phase 8: synthetic stream, two laps
ONLINE_POINTS = 131_072        # configs/default.yaml encoding.max_points
ONLINE_WARM_SCANS = 10         # reported apart from the steady scans
VERIFY_QUERIES = 10            # phase 8: queries whose candidates both
                               # verifier backends check
TRACE_FRAMES = 30              # phase 8: keyframes under torch.profiler

# configs/training.yaml (with its parent default.yaml), the sections the
# training pipeline reads, built in code: the card has no PyYAML
TRAINING_CONFIG = {
    "encoding": {"n_elevation": 16, "n_azimuth": 360,
                 "elevation_range": [-24.8, 2.0], "max_range": 80.0,
                 "min_range": 1.0, "elevation_mode": "clip",
                 "target_elevation_bins": 16, "n_bins": 50, "alpha": 2.0,
                 "epsilon": 1e-8, "interpolate_empty": True,
                 "ring_major": False, "max_points": 131072},
    "keyframe": {"distance_threshold": 0.5, "rotation_threshold": 15.0,
                 "overlap_threshold": 0.7, "temporal_threshold": 5.0,
                 "voxel_size": 0.2, "max_keyframes": 100000,
                 "temporal_neighbors": 5},
    "gnn": {"input_dim": 800, "hidden_dim": 256, "output_dim": 800,
            "n_layers": 3, "dropout": 0.1, "residual": True, "edge_dim": 2},
    "system": {"seed": 42, "checkpoint_dir": "checkpoints"},
    "training": {"learning_rate": 5e-4, "weight_decay": 1e-5,
                 "n_epochs": 50, "triplets_per_step": 4096,
                 "early_stopping": True, "patience": 10, "grad_clip": 1.0,
                 "mixed_precision": False},
    "triplet": {"margin": 0.1, "positive_distance_max": 5.0,
                "positive_temporal_min": 30, "negative_distance_min": 10.0,
                "negative_distance_max": 50.0, "mining_strategy": "hard",
                "n_negatives_per_anchor": 1},
    "validation": {"recall_k_values": [1, 5, 10]},
    "checkpoint": {"save_best": True, "save_last": True},
    "ablation": {"disable_gnn": False, "disable_temporal_edges": False},
}


def _general_scans(n: int, seed: int):
    """Arbitrary-order scans of N_POINTS points: directions a little wider
    than the elevation band (clip mode puts them in the edge rows), ranges
    on both sides of the 1-80 m gate, and a NaN padding tail per scan."""
    import numpy as np
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, (n, N_POINTS))
    el = rng.uniform(np.deg2rad(-26.0), np.deg2rad(3.0), (n, N_POINTS))
    r = rng.uniform(0.5, 90.0, (n, N_POINTS))
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el), rng.uniform(0, 1, r.shape)],
                   axis=-1).astype(np.float32)
    for i, tail in enumerate(rng.integers(0, N_POINTS // 8, n)):
        pts[i, N_POINTS - tail:] = np.nan
    return pts


def _sweep_scans(n: int, seed: int):
    """Scans as a sensor's file stores them: the rings of
    ``make_structured_ring_scans`` (N_RINGS x PER_RING, full density)
    flattened ring-major to (N_POINTS, 4), consecutive points sharing an
    azimuth column, with a NaN padding tail per scan."""
    import numpy as np
    from neural_spectral_codec_torch.ops.ring_path import (
        make_structured_ring_scans)
    from neural_spectral_codec_torch.ops.spectral import SpectralEncoderConfig
    pts = make_structured_ring_scans(n, N_RINGS, PER_RING,
                                     SpectralEncoderConfig().projection,
                                     seed=seed).reshape(n, N_POINTS, 4)
    rng = np.random.default_rng(seed + 1)
    for i, tail in enumerate(rng.integers(0, N_POINTS // 8, n)):
        pts[i, N_POINTS - tail:] = np.nan
    return np.ascontiguousarray(pts)


def _edge_points(n: int, seed: int, proj):
    """Points at the plain version's bin edges (angles k/A of a turn and
    the row boundaries, in float64), on the x and y axes, on z = 0 and at
    the origin: where the kernel's bin test defers to float64 angles."""
    import numpy as np
    rng = np.random.default_rng(seed)
    az = -np.pi + rng.integers(0, proj.n_azimuth + 1, n) * (
        2 * np.pi / proj.n_azimuth)
    el = proj.elevation_min + rng.integers(0, proj.n_elevation + 1, n) * (
        proj.elevation_span / proj.n_elevation)
    r = rng.uniform(1.5, 70.0, n)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el), np.zeros(n)], axis=-1).astype(np.float32)
    pts[: n // 8, 1] = 0.0
    pts[n // 8: n // 4, 0] = 0.0
    pts[n // 4: 3 * n // 8, 2] = 0.0
    pts[-3:] = [[0, 0, 0, 0], [0, 0, 5, 0], [-5, -0.0, 0, 0]]
    return pts


def _time_ms(fn) -> float:
    from neural_spectral_codec_torch.utils.timing import time_ms
    return time_ms(fn, calls=TIMED_CALLS)


def _bound(n_bytes: float, n_flops: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take,
    each input read once and each output written once at the memory rate,
    or the fp32 operations at the peak rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _spectral_ops(imgs, cfg) -> int:
    """fp32 operations the spectral kernel's function needs on ``imgs``
    (B, E, A): the |rDFT| with columns a and A - a of a row folded (2 FMAs
    per pooled row, frequency and column pair, an add for the middle
    column of an even A, 3 for the magnitude, 1 to bin it), the fold (2
    per row and column pair), the pooling (an FMA per pixel of each
    window) and the interpolation (4 per empty pixel of a row that holds a
    valid one; rows the fill copies are not counted, so the bound stays a
    least time)."""
    import torch
    b, n_elev, n_azim = imgs.shape
    n_t, n_f = cfg.target_elevation_bins, cfg.n_freqs
    half = (n_azim - 1) // 2
    window = sum(-(-(t + 1) * n_elev // n_t) - t * n_elev // n_t
                 for t in range(n_t))
    per_scan = (n_t * n_f * (4 * half + (n_azim % 2 == 0) + 3 + 1)
                + 2 * n_t * half + 2 * window * n_azim)
    n_interp = 0
    if cfg.interpolate_empty:
        valid = imgs > 0
        n_interp = int((~valid & valid.any(-1, keepdim=True)).sum())
    return b * per_scan + 4 * n_interp


def _device_times(name: str, wrapper) -> dict:
    """A kernel's own device time, apart from its wrapper: torch.profiler
    over PROFILED_CALLS wrapper calls (kernel time by name), and CUDA
    events around QUEUED_CALLS bare C-entry launches of the last call's
    arguments, queued behind a spin kernel."""
    from neural_spectral_codec_torch.utils.timing import (
        kernel_device_ms, time_queued_ms)
    kernel = _all_kernels()[name]
    keep = wrapper()            # its tensors stay alive for the bare loop
    queued = time_queued_ms(kernel.bare(), n=QUEUED_CALLS)
    del keep
    prof, seen = kernel_device_ms(wrapper, KERNEL_NAMES[name],
                                  calls=PROFILED_CALLS)
    return {"profiler_ms": prof, "profiled_launches": seen,
            "queued_ms": queued,
            "device_ms": prof if prof is not None else queued}


def _only_kernel(name: str, wrapper) -> None:
    """One wrapper call enqueues its kernel and no other device
    operation (the output allocation enqueues none)."""
    from neural_spectral_codec_torch.utils.timing import device_ops
    wrapper()
    ops = [op for op, _ in device_ops(wrapper)]
    print(f"{name}: one wrapper call enqueues {ops}", flush=True)
    _check(len(ops) == 1 and KERNEL_NAMES[name][0] in ops[0],
           f"{name}: a wrapper call enqueues {ops}, not only its kernel")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _check_cpu_image(name: str, got, on_cpu) -> None:
    """The card's image equals the CPU plain path's: both round angles
    and square roots from float64 (ops/range_image.py)."""
    n_diff = int((on_cpu != got.cpu()).sum())
    print(f"{name}: kernel == plain on the card; vs the CPU plain path "
          f"{n_diff} of {got.numel()} pixels differ", flush=True)
    _check(n_diff == 0, f"{name}: the card's image differs from the CPU's")


def _sweep_rings(rows, per_ring: int, n_turns: float, seed: int, proj):
    """One scan of rings at their rows' elevation centers, each sweeping
    ``n_turns`` turns of azimuth (n_turns > 1: extra wrap events)."""
    import numpy as np
    from neural_spectral_codec_torch.ops.ring_path import (
        ring_elevation_centers)
    rng = np.random.default_rng(seed)
    el = ring_elevation_centers(proj, proj.n_elevation)[list(rows)]
    az = rng.uniform(0, 2 * np.pi, (1, len(rows), 1)) \
        + np.linspace(0, n_turns * 2 * np.pi, per_ring)[None, None]
    r = rng.uniform(0.5, 90.0, (1, len(rows), per_ring))
    ce, se = np.cos(el)[None, :, None], np.sin(el)[None, :, None]
    return np.stack([r * ce * np.cos(az), r * ce * np.sin(az),
                     r * se * np.ones_like(az), np.zeros_like(az)],
                    axis=-1).astype(np.float32)


def _edge_cases(device) -> None:
    """Options and inputs the serving run does not reach, each kernel
    against its plain version on the card: drop mode, 3-channel points,
    points on bin edges and axes (the general kernel's float64 path), an
    empty batch of points, n_folds = 1 and 3 with extra wraps and leading
    holes, rings on a subset of rows, no interpolation, another alpha."""
    import torch
    from neural_spectral_codec_torch.ops import (
        projection_kernel, ring_kernel, spectral_kernel)
    from neural_spectral_codec_torch.ops.range_image import (
        project_points_batch_plain)
    from neural_spectral_codec_torch.ops.ring_path import (
        project_rings_batch_plain)
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_images_plain)

    drop = SpectralEncoderConfig(elevation_mode="drop",
                                 elevation_range_deg=(-20.0, 0.0))
    pts = torch.from_numpy(_general_scans(2, SEED + 11)).to(device)
    edge = torch.from_numpy(_edge_points(40_000, SEED + 13,
                                         drop.projection)).to(device)
    for name, p, proj in (("drop", pts, drop.projection),
                          ("xyz", pts[..., :3].contiguous(),
                           SpectralEncoderConfig().projection),
                          ("edges, drop", edge[None], drop.projection),
                          ("edges, clip", torch.stack([edge, edge.flip(0)]),
                           SpectralEncoderConfig().projection),
                          ("N=0", pts[:, :0], drop.projection)):
        got = projection_kernel.project_points_cuda(p, proj)
        _check(torch.equal(got, project_points_batch_plain(p, proj)),
               f"projection kernel != plain version ({name})")
    rows = (3, 5, 9, 40, 41, 63)
    scan = _sweep_rings(rows, 1500, 2.6, SEED + 12, drop.projection)
    scan[0, 1, :200] = float("nan")                     # leading holes
    scan[0, 2, 700:900] = float("nan")                  # interior holes
    rings = torch.from_numpy(scan).to(device)
    for n_folds in (1, 2, 3):
        for proj in (SpectralEncoderConfig().projection, drop.projection):
            got = ring_kernel.project_rings_cuda(rings, proj, rows, n_folds)
            want = project_rings_batch_plain(rings, proj, rows, n_folds)
            _check(torch.equal(got, want), f"ring kernel != plain version "
                   f"(n_folds={n_folds}, {proj.elevation_mode})")
    imgs = project_points_batch_plain(pts, drop.projection)
    for cfg, alpha in ((drop._replace(interpolate_empty=False), 2.0),
                       (drop, 1.3)):
        err = float((spectral_kernel.encode_images_cuda(imgs, alpha, cfg)
                     - encode_images_plain(imgs, alpha, cfg)).abs().max())
        _check(err <= SPECTRAL_TOL, f"spectral kernel vs plain {err:.3e} "
               f"(interpolate={cfg.interpolate_empty}, alpha={alpha})")
    print("edge cases: drop mode, xyz input, points on bin edges and axes, "
          "N=0, n_folds 1-3 with extra wraps and holes, partial rows, no "
          "interpolation, alpha 1.3: kernels match their plain versions",
          flush=True)


def _spectral_shapes(gen) -> None:
    """The spectral kernel against its plain version at B=1 (the serve
    shape) and B=8, at E=64, the training configuration's E=16 (T=16, no
    pooling) and an E that T does not divide (E=20), each with
    interpolation on and off and alpha 2.0 and 1.3; at B=8 with empty rows
    and an all-empty scan."""
    import itertools

    import torch
    from neural_spectral_codec_torch.ops import spectral_kernel
    from neural_spectral_codec_torch.ops.range_image import (
        project_points_batch_plain)
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_images_plain)
    worst = 0.0
    for n_elev, batch in itertools.product((64, 16, 20), (1, BATCH)):
        base = SpectralEncoderConfig(n_elevation=n_elev)
        imgs = project_points_batch_plain(gen[:batch], base.projection)
        if batch > 1:
            imgs[1, : n_elev // 4] = 0.0                # empty rows
            imgs[2] = 0.0                               # empty scan
        imgs = imgs.contiguous()
        for interp in (True, False):
            for alpha in (2.0, 1.3):
                cfg = base._replace(interpolate_empty=interp)
                got = spectral_kernel.encode_images_cuda(imgs, alpha, cfg)
                err = float((got - encode_images_plain(imgs, alpha, cfg))
                            .abs().max())
                worst = max(worst, err)
                _check(err <= SPECTRAL_TOL and
                       bool(torch.isfinite(got).all()),
                       f"spectral kernel vs plain {err:.3e} (E={n_elev}, "
                       f"B={batch}, interpolate={interp}, alpha={alpha})")
    print(f"spectral kernel: B=1 and B={BATCH}, E=64, 16 and 20, "
          f"interpolation on and off, alpha 2.0 and 1.3: max abs err vs "
          f"plain {worst:.3e}",
          flush=True)


def _probe_kernels(device) -> dict:
    """The three probe kernels against their plain versions at the probe
    shapes, the roll kernels also in ROLL_CASES; returns {name: record
    fields} (max abs err, times, bound; for the roll kernels also the
    device time with a cold L2)."""
    import itertools

    import numpy as np
    import torch
    from neural_spectral_codec_torch.ops import probe_kernels as pk
    from neural_spectral_codec_torch.ops.ring_kernel import project_rings_cuda
    from neural_spectral_codec_torch.ops.ring_path import (
        make_structured_ring_scans)
    from neural_spectral_codec_torch.ops.spectral import SpectralEncoderConfig
    from neural_spectral_codec_torch.utils.timing import time_loop_ms

    proj = SpectralEncoderConfig().projection
    rows = tuple(range(N_RINGS))
    scans = make_structured_ring_scans(BATCH, N_RINGS, PER_RING, proj,
                                       seed=SEED + 20)
    extra = _sweep_rings(rows, PER_RING, 2.6, SEED + 21, proj)[0]
    extra[::5, ::9] = np.nan                            # scattered holes
    extra[3, :300] = np.nan                             # leading holes
    extra[7, 900:1400] = np.nan                         # interior holes
    scans[-1] = extra                                   # extra wrap events
    scans = torch.from_numpy(scans).to(device)
    key, vals = pk.ring_keys_padded(scans, proj)        # (512, 2176)
    for n_folds in (1, 2, 3):
        got = pk.ring_fold_probe(key, vals, proj.n_azimuth, n_folds)
        want = pk.ring_fold_rows_plain(key, vals, proj.n_azimuth, n_folds)
        _check(torch.equal(got, want), f"ring probe != plain version "
               f"(n_folds={n_folds}, {int((got != want).sum())} slots)")
        image = project_rings_cuda(scans, proj, rows, n_folds)
        _check(torch.equal(pk.fold_min_rows(got, BATCH, N_RINGS,
                                            proj.n_azimuth, n_folds), image),
               f"ring probe's rows != ring kernel's image (n_folds="
               f"{n_folds})")
    n_variants = 0
    for k in range(1, len(pk.PHASES) + 1):
        for skip in itertools.combinations(pk.PHASES, k):
            out = pk.ring_fold_probe(key, vals, proj.n_azimuth, 2, skip)
            _check(bool(torch.isfinite(out).all()),
                   f"ring probe without {skip}: non-finite rows")
            n_variants += 1
    print(f"ring probe: bit-equal to its plain version for n_folds 1-3 and "
          f"to the ring kernel after the fold min; {n_variants} ablation "
          f"variants launch with finite rows", flush=True)
    _ring_probe_cases(device, key, vals)

    rng = np.random.default_rng(SEED + 22)
    wpad = pk.folded_width(proj.n_azimuth, 2)
    floors = {}
    for width in (key.shape[1], wpad):
        u = torch.from_numpy(rng.uniform(0, 1, (key.shape[0], width))
                             .astype(np.float32)).to(device)
        floors[width] = (torch.round(u * 64) / 8, u)    # ties in x
    for width, n_stages, n_arrays in ((key.shape[1], 12, 1),
                                      (key.shape[1], 12, 2),
                                      (key.shape[1], 40, 2), (wpad, 10, 2)):
        x, y = floors[width]
        got = pk.roll_floor(x, y, n_stages, n_arrays)
        _check(torch.equal(got, pk.roll_floor_plain(x, y, n_stages,
                                                    n_arrays)),
               f"roll floor != plain version ({width} wide, {n_stages} "
               f"stages, {n_arrays} arrays)")
    xroll = torch.from_numpy(rng.uniform(0, 1, (BATCH * N_RINGS, 2112))
                             .astype(np.float32)).to(device)
    chain = pk.roll_min_chain(xroll, 64)
    _check(torch.equal(chain, pk.roll_min_chain_plain(xroll, 64)),
           "roll+min chain != plain version")
    print("roll floor (1 and 2 arrays, 10-40 stages, 2176 and 768 wide) "
          "and roll+min chain (64 stages, 512 x 2112): bit-equal to their "
          "plain versions", flush=True)
    _roll_cases(device)

    x, y = floors[key.shape[1]]
    wpad = pk.folded_width(proj.n_azimuth, 2)
    pairs = {
        "ring_probe": (lambda: pk.ring_fold_probe(key, vals, proj.n_azimuth,
                                                  2),
                       lambda: pk.ring_fold_rows_plain(
                           key, vals, proj.n_azimuth, 2),
                       4 * (key.numel() + vals.numel()
                            + key.shape[0] * wpad)),
        "roll_floor": (lambda: pk.roll_floor(x, y, 12, 2),
                       lambda: pk.roll_floor_plain(x, y, 12, 2),
                       4 * 3 * x.numel()),
        "roll_min_chain": (lambda: pk.roll_min_chain(xroll, 64),
                           lambda: pk.roll_min_chain_plain(xroll, 64),
                           4 * 2 * xroll.numel()),
    }
    flush = torch.empty(COLD_FLUSH_BYTES // 4, device=device)
    key1, vals1 = key[:N_RINGS].contiguous(), vals[:N_RINGS].contiguous()
    out = {}
    for name, (kernel, plain, n_bytes) in pairs.items():
        err = float((kernel() - plain()).abs().max())
        # plain, kernel, kernel, plain, in one call on one card
        p0 = time_loop_ms(plain, n=20)
        k0, k1 = time_loop_ms(kernel, n=200), time_loop_ms(kernel, n=200)
        p1 = time_loop_ms(plain, n=20)
        bound_ms, bound_by = _bound(n_bytes)
        out[name] = {"max_abs_err": err, "ms": (k0 + k1) / 2,
                     "plain_ms": (p0 + p1) / 2, "wrapper_ms": _time_ms(kernel),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     **_device_times(name, kernel)}
        # a cold L2: a 64 MB write before each call, not counted
        out[name]["device_ms_cold"] = _profiled_ms(
            name, lambda kernel=kernel: (flush.zero_(), kernel()))
        t = out[name]
        b1 = ""
        if name == "ring_probe":
            # B=1: the 64 rings of one scan
            def call1():
                return pk.ring_fold_probe(key1, vals1, proj.n_azimuth, 2)
            t.update({"bound_ms_b1": _bound(4 * (key1.numel() + vals1.numel()
                                                 + N_RINGS * wpad))[0],
                      "device_ms_b1": _profiled_ms(name, call1),
                      "device_ms_cold_b1": _profiled_ms(
                          name, lambda: (flush.zero_(), call1()))})
            b1 = (f"; B=1 device {_fmt_ms(t['device_ms_b1'])} ms, cold L2 "
                  f"{_fmt_ms(t['device_ms_cold_b1'])} ms, bound "
                  f"{t['bound_ms_b1']:.5f} ms")
        print(f"kernel {name}: device {t['device_ms']:.5f} ms "
              f"(profiler {t['profiler_ms']}, queued bare "
              f"{t['queued_ms']:.5f}), cold L2 "
              f"{_fmt_ms(t['device_ms_cold'])} ms{b1}, wrapper "
              f"{t['wrapper_ms']:.5f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}); loops kernel {k0:.5f}/{k1:.5f}, plain "
              f"{p0:.5f}/{p1:.5f} (B={BATCH})", flush=True)
    return out


def _special_rows(n_rows: int, width: int, seed: int, first: int = 0):
    """(x, y) float32 rows for the roll kernels' edge cases: x in steps of
    1/8 over [-1, 2] (ties); with r = row + ``first``, rows r = 1 mod 4
    have runs of +0 and -0 as their min, r = 2 mod 4 scattered +inf and
    -inf, r = 3 mod 4 one NaN, r = 7 mod 8 a NaN every 97 columns; y
    uniform with -0 every 13th column (it tells the chosen index apart)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 25, (n_rows, width)) / 8 - 1).astype(np.float32)
    y = rng.uniform(-1, 1, (n_rows, width)).astype(np.float32)
    y[:, ::13] = -0.0
    r = np.arange(n_rows) + first
    zeros = np.flatnonzero(r % 4 == 1)
    x[zeros] = np.abs(x[zeros]) + np.float32(0.125)
    x[np.ix_(zeros, np.arange(0, width, 11))] = -0.0
    x[np.ix_(zeros, np.arange(5, width, 17))] = 0.0
    inf = np.flatnonzero(r % 4 == 2)
    x[np.ix_(inf, rng.integers(0, width, width // 50 + 1))] = np.inf
    x[np.ix_(inf, rng.integers(0, width, width // 80 + 1))] = -np.inf
    nan = np.flatnonzero(r % 4 == 3)
    x[nan, rng.integers(0, width, len(nan))] = np.nan
    x[np.ix_(np.flatnonzero(r % 8 == 7), np.arange(0, width, 97))] = np.nan
    return x, y


def _on_card(a, device, misaligned: bool):
    """A contiguous CUDA copy of ``a``; with ``misaligned`` its data starts
    4 bytes past a 16-byte boundary."""
    import torch
    t = torch.from_numpy(a)
    if not misaligned:
        return t.to(device)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _roll_cases(device) -> None:
    """Both roll kernels bit-equal (int32 views) to their plain versions
    on the card in every case of ROLL_CASES."""
    import torch
    from neural_spectral_codec_torch.ops import probe_kernels as pk
    for i, (rows, width, n_stages, n_arrays, misaligned) in enumerate(
            ROLL_CASES):
        x, y = _special_rows(rows, width, SEED + 40 + i, first=i % 4)
        x, y = _on_card(x, device, misaligned), _on_card(y, device, misaligned)
        if n_arrays:
            got = pk.roll_floor(x, y, n_stages, n_arrays)
            want = pk.roll_floor_plain(x, y, n_stages, n_arrays)
        else:
            got = pk.roll_min_chain(x, n_stages)
            want = pk.roll_min_chain_plain(x, n_stages)
        diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        _check(diff == 0, f"roll kernel != plain version ({rows} x {width}, "
               f"{n_stages} stages, arrays {n_arrays}, misaligned "
               f"{misaligned}: {diff} elements)")
    print(f"roll kernels: {len(ROLL_CASES)} more cases bit-equal to their "
          "plain versions (windows shorter than the row, NaN, +-0 and "
          "+-inf rows, widths 2175 and 2110, misaligned rows, single rows)",
          flush=True)


def _probe_key_rows(n_rows: int, width: int, seed: int):
    """(keys, ranges) float32 rows for the ring probe's edge cases: sweeps
    of 2.6 turns (extra wrap events) from random starts with scattered
    holes, a leading, an interior and a trailing invalid run on rows 1-3
    mod 8, rows 4 mod 8 with no valid point, rows 5 mod 8 falling one bin
    a point (every valid point after the first a wrap), keys outside
    [0, 360) as holes; ranges in [0.5, 80) with ties, +inf at holes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 360, (n_rows, 1)) + np.linspace(0, 2.6 * 360, width)
    key = (np.floor(az) % 360).astype(np.float32)
    key[rng.uniform(size=key.shape) < 0.1] = -1.0
    kind = np.arange(n_rows) % 8
    key[kind == 1, : (2 * width) // 5] = -1.0
    key[kind == 2, width // 3: (2 * width) // 3] = 400.0
    key[kind == 3, width - width // 4:] = -1.0
    key[kind == 4] = -1.0
    key[kind == 5] = (359 - np.arange(width)) % 360
    vals = (rng.integers(1, 160, key.shape) / 2).astype(np.float32)
    vals[~((key >= 0) & (key < 360))] = np.inf
    return key, vals


def _ring_probe_cases(device, key, vals) -> None:
    """The ring probe bit-equal to its plain version for n_folds 1-3 on:
    B=1 (64 rows, 512 threads a CTA), a single row, a width that is not
    a multiple of 4 (the scalar loads), rows 4 bytes off a 16-byte
    boundary, all-invalid rows and rows whose points all wrap
    (``_probe_key_rows``), and the widest rows the kernel takes (12
    points a thread at 512 threads) and one point less (the scalar
    loads); the next width must be refused with the wrapper's error, and
    a call after it must still be right."""
    import torch
    from neural_spectral_codec_torch.ops import probe_kernels as pk
    n_azim = 360
    widest = 12 * 512      # kPer points a thread at kManyThreads threads
    rows = {name: _probe_key_rows(n, w, SEED + 50 + i)
            for i, (name, n, w) in enumerate((
                ("2175 wide", 512, 2175), ("misaligned", 512, 2176),
                ("edge rows, B=1", N_RINGS, 2176), ("edge rows", 512, 2176),
                (f"widest {widest}", 3, widest),
                (f"widest - 1 {widest - 1}", 3, widest - 1)))}
    cases = {"B=1": (key[:N_RINGS].contiguous(), vals[:N_RINGS].contiguous()),
             "single row": (key[:1].contiguous(), vals[:1].contiguous())}
    for name, (k, v) in rows.items():
        misaligned = name == "misaligned"
        cases[name] = (_on_card(k, device, misaligned),
                       _on_card(v, device, misaligned))
    for name, (k, v) in cases.items():
        for n_folds in (1, 2, 3):
            got = pk.ring_fold_probe(k, v, n_azim, n_folds)
            want = pk.ring_fold_rows_plain(k, v, n_azim, n_folds)
            diff = int((got.view(torch.int32)
                        != want.view(torch.int32)).sum())
            _check(diff == 0, f"ring probe != plain version ({name}, "
                   f"{tuple(k.shape)}, n_folds={n_folds}: {diff} slots)")
    wide = _probe_key_rows(2, widest + 1, SEED + 60)
    try:
        pk.ring_fold_probe(torch.from_numpy(wide[0]).to(device),
                           torch.from_numpy(wide[1]).to(device), n_azim, 2)
        refused = False
    except RuntimeError as e:
        refused = "nsc_ring_probe" in str(e)
    _check(refused, f"ring probe: rows of {widest + 1} not refused")
    k, v = cases["edge rows"]
    _check(torch.equal(pk.ring_fold_probe(k, v, n_azim, 2),
                       pk.ring_fold_rows_plain(k, v, n_azim, 2)),
           "ring probe: wrong after a refused layout")
    print(f"ring probe: {len(cases)} more cases bit-equal for n_folds 1-3 "
          f"({', '.join(cases)}); rows of {widest + 1} refused", flush=True)


def _profiled_ms(name: str, call):
    """torch.profiler device ms per call of kernel ``name`` over
    PROFILED_CALLS calls of ``call``; a window that records no device
    time for it (it happens now and then) is taken again, up to three
    times, then None."""
    from neural_spectral_codec_torch.utils.timing import kernel_device_ms
    for _ in range(3):
        ms, _ = kernel_device_ms(call, KERNEL_NAMES[name],
                                 calls=PROFILED_CALLS)
        if ms is not None:
            return ms
    return None


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f}"


def _probe_paths() -> dict:
    """Phase 5: both stage-profile entry points, each with all six launch
    counts set to 0 just before it and read just after; each must launch
    the kernels its lines time. Returns {entry point: launches}."""
    from neural_spectral_codec_torch.experiments import (
        profile_hotpath, ring_stage_probe)
    runs = (
        ("ring_stage_probe", lambda: ring_stage_probe.main(
            ["--iters", "20", "--rounds", "3"]),
         ("ring_probe", "roll_floor", "ring_fold")),
        ("profile_hotpath", lambda: profile_hotpath.main(["--iters", "5"]),
         ("ring_probe", "roll_min_chain", "spectral", "ring_fold",
          "project")),
    )
    by_path = {}
    for name, run, needed in runs:
        _, launches = _counted(run)
        print(f"probes: {name} launches {launches}", flush=True)
        _check(all(launches[n] > 0 for n in needed),
               f"{name} never launched one of {needed}: {launches}")
        by_path[name] = launches
    return by_path


def _structured(device) -> dict:
    """Phase 6: ``encode_structured`` on four full-density flat streams,
    each descriptor against ``encode_points_batch`` on the same cloud;
    returns the launches."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.ops.ring_path import (
        encode_structured, infer_ring_ids_by_elevation,
        infer_ring_ids_from_sweep, make_structured_ring_scans,
        prepare_structured)
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_points_batch)

    cfg = SpectralEncoderConfig()
    scans = make_structured_ring_scans(4, N_RINGS, PER_RING, cfg.projection,
                                       seed=SEED + 30)
    sweep = scans[0].reshape(-1, 4)
    nclt = scans[1].transpose(1, 0, 2).reshape(-1, 4)
    helipr = scans[2].transpose(1, 0, 2).reshape(-1, 4)
    # a scan in no sensor order (a NaN tail here would become one ring of
    # every padding point, and the ring bucketing would allocate R x P)
    cloud = scans[3].reshape(-1, 4)[
        np.random.default_rng(SEED + 31).permutation(N_POINTS)]
    streams = {
        "sweep order (KITTI)": (sweep, infer_ring_ids_from_sweep(sweep), True),
        "interleaved (NCLT)": (nclt, infer_ring_ids_by_elevation(nclt), True),
        "ring field (HeLiPR)": (helipr, np.tile(np.arange(N_RINGS), PER_RING),
                                True),
        "unstructured": (cloud, infer_ring_ids_from_sweep(cloud), False),
    }
    want = {}
    for name, (flat, rid, ring) in streams.items():
        _check((prepare_structured(flat, rid, cfg) is not None) == ring,
               f"structured: {name} took the wrong branch")
        want[name] = encode_points_batch(
            torch.from_numpy(flat[None]).to(device), cfg.alpha, cfg)[0]
    got, launches = _counted(lambda: {
        name: encode_structured(flat, rid, cfg.alpha, cfg, device=device)
        for name, (flat, rid, _) in streams.items()})
    for name, (flat, _, ring) in streams.items():
        err = float((got[name] - want[name]).abs().max())
        _check(got[name].device.type == "cuda" and err <= 1e-6 and
               bool(torch.isfinite(got[name]).all()),
               f"structured: {name} descriptor {err:.3e} from the general "
               "path")
        print(f"structured: {name}, {len(flat)} points, "
              f"{'ring' if ring else 'general'} path, {err:.3e} from "
              f"encode_points_batch", flush=True)
    print(f"structured: launches {launches}", flush=True)
    _check({k: launches[k] for k in ("spectral", "ring_fold", "project")}
           == {"spectral": 4, "ring_fold": 3, "project": 1},
           f"structured: unexpected launches {launches}")
    return launches


def _all_kernels() -> dict:
    from neural_spectral_codec_torch.ops import (
        probe_kernels, projection_kernel, ring_kernel, spectral_kernel)
    return {"spectral": spectral_kernel.KERNEL,
            "ring_fold": ring_kernel.KERNEL,
            "project": projection_kernel.KERNEL,
            "ring_probe": probe_kernels.RING_PROBE,
            "roll_floor": probe_kernels.ROLL_FLOOR,
            "roll_min_chain": probe_kernels.ROLL_MIN_CHAIN}


def _counted(run) -> tuple:
    """(run's result, {kernel: launches}) with every count set to 0 just
    before ``run`` and read just after."""
    kernels = _all_kernels()
    for k in kernels.values():
        k.launches = 0
    out = run()
    return out, {n: k.launches for n, k in kernels.items()}


def _train_step_vs_cpu(device) -> None:
    """Phase 7a: hard-negative mining and one full-width train step on the
    card against the same on the CPU, from identical state."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.experiments.scale_100k import (
        synthetic_city)
    from neural_spectral_codec_torch.keyframe.graph import (
        build_graph, graph_to_tensors)
    from neural_spectral_codec_torch.models import SpectralGNN
    from neural_spectral_codec_torch.models.gnn import gauge_parameters
    from neural_spectral_codec_torch.training.miner import TripletMiner
    from neural_spectral_codec_torch.training.trainer import (
        make_optimizer, train_step)

    desc, poses, _ = synthetic_city(TRAIN_NODES, revisit_period=128)
    mined = {d: TripletMiner(seed=SEED, device=d).mine_triplets(desc, poses)
             for d in ("cpu", device)}
    trip_cpu, trip_dev = mined["cpu"], mined[device]
    _check(len(trip_cpu) > 100 and
           np.array_equal(trip_cpu[:, [0, 2]], trip_dev[:, [0, 2]]),
           f"train: the card's anchors / hard negatives differ from the "
           f"CPU's ({len(trip_dev)} vs {len(trip_cpu)} triplets)")
    batch = np.zeros((4096, 3), np.int64)
    batch[:len(trip_cpu)] = trip_cpu
    tmask = np.arange(4096) < len(trip_cpu)
    graph_np = build_graph(desc, poses, temporal_neighbors=5)
    model_cpu = SpectralGNN(dropout=0.0,
                            generator=torch.Generator().manual_seed(SEED))
    model_dev = copy.deepcopy(model_cpu).to(device)
    gauge = gauge_parameters(model_cpu)
    out = {}
    for name, model, dev in (("cpu", model_cpu, "cpu"),
                             ("card", model_dev, device)):
        before = {k: v.detach().clone().cpu()
                  for k, v in model.named_parameters()}
        b = torch.from_numpy(batch).to(dev)
        t0 = time.perf_counter()
        loss = train_step(model, make_optimizer(model, 5e-4, 1e-5),
                          graph_to_tensors(graph_np, dev), b[:, 0], b[:, 1],
                          b[:, 2], torch.from_numpy(tmask).to(dev), 0.1,
                          grad_clip=1.0)
        loss = float(loss)
        out[name] = (loss, before, {k: v.grad.cpu() for k, v in
                                    model.named_parameters()},
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()},
                     time.perf_counter() - t0)
    (l_cpu, p0, g_cpu, s_cpu, t_cpu), (l_dev, _, g_dev, s_dev, t_dev) = \
        out["cpu"], out["card"]
    err = {"loss": abs(l_dev - l_cpu) / max(1.0, abs(l_cpu))}
    for k, g in g_cpu.items():
        if k not in gauge:
            err[f"grad {k}"] = float((g_dev[k] - g).abs().max()) / max(
                1e-12, float(g.abs().max()))
    n_free = 0
    for k, v in s_cpu.items():
        if k in gauge or k.endswith("num_batches_tracked"):
            continue
        d = (s_dev[k] - v).abs()
        if k in g_cpu:      # a parameter: skip elements of sign-free grads
            free = g_cpu[k].abs() < 1e-3 * g_cpu[k].abs().max()
            n_free += int(free.sum())
            d = d[~free]
        err[k] = float(d.max()) if d.numel() else 0.0
    worst = max(err, key=err.get)
    moved = max(float((s_cpu[k] - p0[k]).abs().max()) for k in p0)
    print(f"train: {TRAIN_NODES} nodes, {len(trip_cpu)} triplets, anchors "
          f"and hard negatives equal on card and CPU; one step: loss "
          f"{l_dev:.6f} (CPU {l_cpu:.6f}), worst {worst} {err[worst]:.3e}; "
          f"largest parameter move {moved:.3e}; {n_free} elements with "
          f"sign-free gradients and {len(gauge)} gauge biases not held; "
          f"host s card {t_dev:.3f}, CPU {t_cpu:.3f}", flush=True)
    _check(math.isfinite(l_dev) and all(v <= TRAIN_TOL for v in err.values()),
           f"train: card vs CPU {worst} {err[worst]:.3e} > {TRAIN_TOL}")


def _train_entry(device) -> dict:
    """Phase 7b: the training entry point, default and ring-major
    encoders; returns {path: launches}."""
    import torch
    from neural_spectral_codec_torch import train_multi_dataset
    from neural_spectral_codec_torch.models import SpectralGNN

    try:
        import yaml
        print(f"train: PyYAML {yaml.__version__} is installed", flush=True)
    except ImportError:
        print("train: PyYAML is not installed; the config is a dict",
              flush=True)
    ring_cfg = copy.deepcopy(TRAINING_CONFIG)
    ring_cfg["encoding"].update({"ring_major": True, "n_elevation": 64})
    runs = (("train", TRAINING_CONFIG, [], ("project", "spectral"),
             ("ring_fold",)),
            ("train_ring", ring_cfg, ["--synthetic-beams", "64",
                                      "--synthetic-sweep-order"],
             ("ring_fold", "spectral"), ()))
    by_path = {}
    for name, cfg, extra, needed, unused in runs:
        with tempfile.TemporaryDirectory(prefix="nsc_train_") as ckpt:
            args = ["--synthetic", "120", "--epochs", "2", "--device",
                    str(device), "--checkpoint-dir", ckpt] + extra
            t0 = time.perf_counter()
            trainer, launches = _counted(
                lambda: train_multi_dataset.main(args, config=cfg))
            wall = time.perf_counter() - t0
            model = SpectralGNN()
            model.load_state_dict(torch.load(
                Path(ckpt) / "final_model.pt", weights_only=True)["model"])
            same = all(torch.equal(v, trainer.model.state_dict()[k].cpu())
                       for k, v in model.state_dict().items())
        pipe = trainer.pipeline
        stages = {k: round(v, 3) for k, v in pipe.stage_seconds.items()}
        print(f"{name}: {wall:.2f} s, scans by path "
              f"{pipe.encoder.path_counts}, losses {trainer.train_losses}, "
              f"best R@1 {trainer.best_val_metric:.4f}, stage s {stages}, "
              f"launches {launches}", flush=True)
        _check(all(launches[k] > 0 for k in needed) and
               all(launches[k] == 0 for k in unused),
               f"{name}: unexpected launches {launches}")
        _check(len(trainer.train_losses) == 2 and
               all(math.isfinite(v) and v > 0 for v in trainer.train_losses),
               f"{name}: losses {trainer.train_losses}")
        _check(same, f"{name}: the checkpoint does not reload to the "
               "trained state_dict")
        by_path[name] = launches
    return by_path


def _scale(device) -> None:
    """Phase 7c: the 100k-scale entry point at SCALE_NODES nodes."""
    from neural_spectral_codec_torch.experiments import scale_100k
    out = scale_100k.main(["--nodes", str(SCALE_NODES), "--device",
                           str(device)])
    _check(math.isfinite(out["avg_loss"]) and
           all(0.0 <= out[f"recall@{k}"] <= 1.0 for k in (1, 5, 10)) and
           out["n_queries"] > 0, f"scale: {out}")


def _write_store(path: Path, n_bins: int, seed: int) -> int:
    """Phase 8's map: STORE_ROWS records through the port's
    ``save_database``: random ^4 histograms, poses spread over 20 km
    (random yaw), no points."""
    import numpy as np
    from neural_spectral_codec_torch.keyframe.selector import Keyframe
    from neural_spectral_codec_torch.retrieval.two_stage import (
        TwoStageRetrieval)
    rng = np.random.default_rng(seed)
    hist = rng.random((STORE_ROWS, n_bins), dtype=np.float32) ** 4
    hist /= hist.sum(axis=1, keepdims=True)
    yaw = rng.uniform(-np.pi, np.pi, STORE_ROWS)
    poses = np.tile(np.eye(4), (STORE_ROWS, 1, 1))
    poses[:, 0, 0] = poses[:, 1, 1] = np.cos(yaw)
    poses[:, 0, 1], poses[:, 1, 0] = -np.sin(yaw), np.sin(yaw)
    poses[:, :2, 3] = rng.uniform(-10_000.0, 10_000.0, (STORE_ROWS, 2))
    store = TwoStageRetrieval(n_bins=n_bins, capacity=1, device="cpu")
    store.keyframes = [Keyframe(i, i, None, poses[i], float(i),
                                descriptor=hist[i])
                       for i in range(STORE_ROWS)]
    return store.save_database(str(path))


def _cpu_descriptors(keyframes, cfg, max_points: int) -> "torch.Tensor":
    """Each keyframe's descriptor by the plain encoder on the CPU, from
    its points padded as the online loop pads them."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.ops.range_image import pad_points
    from neural_spectral_codec_torch.ops.spectral import encode_points_batch
    out = []
    for lo in range(0, len(keyframes), 8):
        pts = np.stack([pad_points(kf.points, max_points)
                        for kf in keyframes[lo:lo + 8]])
        out.append(encode_points_batch(torch.from_numpy(pts), cfg.alpha,
                                       cfg))
    return torch.cat(out)


def _verifier_backends(pipe, device) -> dict:
    """The stage-1 candidates of the last VERIFY_QUERIES queries, each
    against the snapshot its query saw, verified by the native backend
    (the run's) and by the torch backend on the card: the same verified
    set, the largest transform difference, ms per pair of each."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.retrieval.verification import (
        GeometricVerifier)
    ret = pipe.retrieval
    nat = ret.verifier
    tv = GeometricVerifier(
        method=nat.method, fitness_threshold=nat.fitness_threshold,
        rmse_threshold=nat.rmse_threshold,
        max_iterations=nat.max_iterations,
        voxel_downsample=nat.voxel_downsample, max_points=nat.max_points,
        backend="torch", device=device)
    kfs = pipe.selector.keyframes
    queries = [kf for i, kf in enumerate(kfs)
               if (i + 1) % 10 == 0][-VERIFY_QUERIES:]
    times = {"native": [], "torch": []}
    pairs, t_diff, disagree = 0, 0.0, []
    for kf in queries:
        cands = ret.query(kf, verify=False, as_of_size=kf.keyframe_id + 1)
        qn, qt = nat.prepare(kf.points), tv.prepare(kf.points)
        for c in cands:
            target = ret.keyframes[c.database_idx]
            if target.points is None:           # a resumed record
                continue
            dn, dt = nat.prepare(target.points), tv.prepare(target.points)
            t0 = time.perf_counter()
            ok_n, T_n, info_n = nat.verify(qn, dn)
            times["native"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ok_t, T_t, info_t = tv.verify(qt, dt)
            torch.cuda.synchronize()
            times["torch"].append(time.perf_counter() - t0)
            pairs += 1
            if ok_n != ok_t:
                disagree.append((kf.keyframe_id, target.keyframe_id,
                                 info_n["fitness"], info_n["rmse"],
                                 info_t["fitness"], info_t["rmse"]))
            elif ok_n:
                t_diff = max(t_diff, float(np.abs(T_n - T_t).max()))
    out = {"pairs": pairs, "max_transform_diff": t_diff,
           "disagreements": disagree,
           "gicp_ms_native": 1e3 * statistics.median(times["native"])
           if times["native"] else None,
           "gicp_ms_torch": 1e3 * statistics.median(times["torch"])
           if times["torch"] else None}
    print(f"online: verifier backends on the stage-1 candidates of "
          f"{len(queries)} queries: {pairs} pairs, disagreements "
          f"{disagree}, largest transform difference {t_diff:.3e}; GICP "
          f"ms per pair (median, prepared clouds) native "
          f"{out['gicp_ms_native']}, torch on the card "
          f"{out['gicp_ms_torch']}", flush=True)
    _check(pairs > 0 and not disagree,
           f"online: verifier backends disagree on {disagree}")
    return out


def _serve_trace(device, frames, cap: int, serve_ms: float) -> None:
    """Device operations of the one-dispatch serving step: a fresh
    session of TRACE_FRAMES keyframes (sync loop closing, no warmup, the
    same capacity, so each query scans as many rows) under torch.profiler;
    per keyframe the device time, the operations and the largest ones by
    time, and the device's busy share of the main run's serve_step."""
    from collections import defaultdict

    from neural_spectral_codec_torch.experiments.online_latency import (
        inference_config, run)
    from neural_spectral_codec_torch.utils.timing import device_ops
    cfg = inference_config(retrieval={"database_capacity": cap},
                           deployment={"warmup": False,
                                       "async_loop_closing": False},
                           monitoring={"enabled": False})
    ops = device_ops(lambda: run(frames[:TRACE_FRAMES], cfg, device,
                                 warmup_scans=0))
    by_name = defaultdict(float)
    for name, us in ops:
        by_name[name[:60]] += us / TRACE_FRAMES
    dev_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"online: torch.profiler over {TRACE_FRAMES} keyframes: "
          f"{len(ops) / TRACE_FRAMES:.1f} device operations and "
          f"{dev_ms:.4f} ms of device time per keyframe, "
          f"{100 * dev_ms / serve_ms:.1f}% of the main run's serve_step "
          f"({serve_ms:.3f} ms); largest, µs per keyframe: "
          f"{[(n, round(us, 2)) for n, us in top]}", flush=True)


def _online(device) -> dict:
    """Phase 8: the online loop (``run_online``) at full width against a
    resumed 100,000-record map; returns its launches."""
    import shutil

    import numpy as np
    import torch
    from neural_spectral_codec_torch.data.synthetic import SyntheticLoader
    from neural_spectral_codec_torch.experiments.online_latency import (
        inference_config, run)
    from neural_spectral_codec_torch.retrieval.two_stage import (
        TwoStageRetrieval)

    cap = STORE_ROWS + ONLINE_FRAMES
    cfg = inference_config(retrieval={"database_capacity": cap})
    print("online: configs/inference.yaml over default.yaml, except "
          "retrieval.spatial_filter_distance 0 (with ground-truth poses "
          "the 50 m filter drops every true revisit), the synthetic stream "
          f"in place of a dataset, and retrieval.database_capacity {cap} "
          f"(the {STORE_ROWS}-record map plus this session's keyframes)",
          flush=True)
    dim = (cfg["encoding"]["target_elevation_bins"]
           * cfg["encoding"]["n_bins"])
    with tempfile.TemporaryDirectory(prefix="nsc_online_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        n = _write_store(tmp / "map.bin", dim, SEED + 40)
        size = (tmp / "map.bin").stat().st_size
        print(f"online: store of {n} records, {size / 1e6:.1f} MB, written "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        base = SyntheticLoader(n_frames=ONLINE_FRAMES, seed=SEED + 41,
                               n_points=ONLINE_POINTS, loops=2.0)
        frames = [base[i] for i in range(ONLINE_FRAMES)]
        print(f"online: {ONLINE_FRAMES} frames of {ONLINE_POINTS} points "
              f"generated in {time.perf_counter() - t0:.2f} s", flush=True)
        for name in ("run1.bin", "run2.bin"):
            shutil.copyfile(tmp / "map.bin", tmp / name)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (pipe, edges, rep), launches = _counted(lambda: run(
            frames, cfg, device, warmup_scans=ONLINE_WARM_SCANS,
            database_path=str(tmp / "run1.bin"), resume_database=True,
            output_g2o=str(tmp / "loops.g2o")))
        peak = torch.cuda.max_memory_allocated() / 2**30
        kfs = pipe.selector.keyframes
        ret = pipe.retrieval.retriever
        print(f"online: one-dispatch serving, async loop closing, "
              f"{len(kfs)} keyframes, {len(edges)} loop closures, database "
              f"{ret.database_size} rows, wall {rep['wall_s']:.2f} s, "
              f"warmup {rep['warmup_s']:.3f} s, peak device memory "
              f"{peak:.3f} GiB, launches {launches}", flush=True)
        print(f"online: per-keyframe latency (host clock between fetches, "
              f"after {ONLINE_WARM_SCANS} warm-up scans) "
              f"{json.dumps(rep['keyframe'])}; warm-up scans "
              f"{json.dumps(rep['warmup_scans'])}; keyframes over "
              f"{rep['budget_ms']:.0f} ms: {rep['keyframes_over_budget']}",
              flush=True)
        print(f"online: stage means ms {json.dumps(rep['stage_mean_ms'])}, "
              f"calls {json.dumps(rep['stage_calls'])}", flush=True)
        _check(len(edges) > 0, "online: the second lap closed no loop")
        _check(all(e["fitness"] >= 0.3 and e["rmse"] <= 0.5
                   for e in edges), "online: an edge below the gates")
        _check("EDGE_SE3:QUAT" in (tmp / "loops.g2o").read_text(),
               "online: no EDGE_SE3:QUAT in the g2o export")
        _check(ret.database_size == STORE_ROWS + len(kfs),
               f"online: database {ret.database_size} rows, not "
               f"{STORE_ROWS} + {len(kfs)}")
        _check(launches["project"] > 0 and launches["spectral"] > 0,
               f"online: a kernel of the path never launched: {launches}")

        t0 = time.perf_counter()
        want = _cpu_descriptors(kfs, pipe.encoder_config,
                                pipe.encoder.max_points)
        got = torch.from_numpy(np.stack([kf.descriptor for kf in kfs]))
        err = float((got - want).abs().max())
        print(f"online: descriptors vs the CPU plain encoder max abs "
              f"{err:.3e} ({time.perf_counter() - t0:.2f} s)", flush=True)
        _check(err <= DESC_TOL, f"online: descriptors differ from the CPU "
               f"path by {err:.3e} > {DESC_TOL}")

        _verifier_backends(pipe, device)
        _serve_trace(device, frames, cap, rep["stage_mean_ms"]["serve_step"])

        split_cfg = inference_config(retrieval={"database_capacity": cap},
                                     deployment={"fused_query": False,
                                                 "async_loop_closing":
                                                 False})
        _, split_edges, split_rep = run(
            frames, split_cfg, device, warmup_scans=ONLINE_WARM_SCANS,
            database_path=str(tmp / "run2.bin"), resume_database=True)
        key = lambda es: sorted((e["source_id"], e["target_id"]) for e in es)
        print(f"online: sync split mode {len(split_edges)} loop closures, "
              f"per-keyframe latency {json.dumps(split_rep['keyframe'])}, "
              f"stage means ms {json.dumps(split_rep['stage_mean_ms'])}",
              flush=True)
        _check(key(split_edges) == key(edges), "online: the split mode's "
               "edge set differs from the one-dispatch mode's")

        t0 = time.perf_counter()
        back = TwoStageRetrieval(n_bins=dim, capacity=cap,
                                 device=device)
        n_back = back.load_database(str(tmp / "run1.bin"))
        rows, rows0 = back.retriever._db_rows, ret._db_rows
        same_map = torch.equal(rows[:STORE_ROWS], rows0[:STORE_ROWS])
        new_err = float((rows[STORE_ROWS:n_back]
                         - rows0[STORE_ROWS:n_back]).abs().max())
        same_pos = torch.equal(back.retriever._db_pos[:n_back],
                               ret._db_pos[:n_back])
        same_ids = [k.keyframe_id for k in back.keyframes] == \
            [k.keyframe_id for k in pipe.retrieval.keyframes]
        print(f"online: save/load round trip of the final store: {n_back} "
              f"records in {time.perf_counter() - t0:.2f} s; the map's rows "
              f"bit-equal {same_map}, this session's rows within "
              f"{new_err:.3e} (the uint16 codec), positions equal "
              f"{same_pos}, ids equal {same_ids}", flush=True)
        _check(n_back == ret.database_size and same_map and same_pos
               and same_ids and new_err <= dim / 65535.0,
               "online: the saved store does not restore the rows")
    return launches


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one "
                         "card")
    from neural_spectral_codec_torch import _build, resolve_device
    from neural_spectral_codec_torch.keyframe.graph import (
        build_graph, graph_to_tensors)
    from neural_spectral_codec_torch.models import SpectralGNN, serve_step
    from neural_spectral_codec_torch.models.serving import encode_scan
    from neural_spectral_codec_torch.ops import (
        projection_kernel, ring_kernel, spectral_kernel)
    from neural_spectral_codec_torch.ops.range_image import (
        project_points_batch_plain)
    from neural_spectral_codec_torch.ops.ring_path import (
        make_structured_ring_scans, project_rings_batch_plain)
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_images_plain)
    from neural_spectral_codec_torch.retrieval import WassersteinRetriever
    from neural_spectral_codec_torch.utils.timing import gpu_label

    # -- 1. device ---------------------------------------------------------
    device = resolve_device("cuda")
    print(gpu_label(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 3. each kernel against its plain version on the card --------------
    cfg = SpectralEncoderConfig()
    proj = cfg.projection
    rows = tuple(range(N_RINGS))
    alpha = cfg.alpha
    gen = torch.from_numpy(_general_scans(BATCH, SEED + 1)).to(device)
    rings = torch.from_numpy(make_structured_ring_scans(
        BATCH, N_RINGS, PER_RING, proj, seed=SEED + 2)).to(device)

    got = projection_kernel.project_points_cuda(gen, proj)
    want = project_points_batch_plain(gen, proj)
    _check(torch.equal(got, want), "projection kernel != plain version "
           f"({int((got != want).sum())} pixels differ)")
    proj_err = float((got - want).abs().max())
    imgs = want.clone()
    _check_cpu_image("project", got, project_points_batch_plain(
        gen.cpu(), proj))
    sweep = torch.from_numpy(_sweep_scans(BATCH, SEED + 8)).to(device)
    for order, x in (("random", gen), ("sweep", sweep)):
        for x_b in (x[:1].contiguous(), x):
            got = projection_kernel.project_points_cuda(x_b, proj)
            want_b = project_points_batch_plain(x_b, proj)
            _check(torch.equal(got, want_b), f"projection kernel != plain "
                   f"version ({order} order, B={x_b.shape[0]}, "
                   f"{int((got != want_b).sum())} pixels differ)")
            proj_err = max(proj_err, float((got - want_b).abs().max()))
    print("project: bit-equal to the plain version in random and sweep "
          "order at B=1 and B=8", flush=True)

    got = ring_kernel.project_rings_cuda(rings, proj, rows)
    want = project_rings_batch_plain(rings, proj, rows)
    _check(torch.equal(got, want), "ring kernel != plain version "
           f"({int((got != want).sum())} pixels differ)")
    ring_err = float((got - want).abs().max())
    _check_cpu_image("ring_fold", got, project_rings_batch_plain(
        rings.cpu(), proj, rows))

    g = torch.Generator(device=device).manual_seed(SEED + 3)
    imgs[1] *= torch.rand(imgs[1].shape, generator=g, device=device) < 0.02
    imgs[2, :3] = 0.0
    imgs[2, 10:14] = 0.0
    imgs[3] = 0.0
    got = spectral_kernel.encode_images_cuda(imgs, alpha, cfg)
    want = encode_images_plain(imgs, alpha, cfg)
    spec_err = float((got - want).abs().max())
    _check(spec_err <= SPECTRAL_TOL,
           f"spectral kernel vs plain: max abs {spec_err:.3e}")
    _check(bool(torch.all(torch.isfinite(got))) and
           float((got[3] - 1.0 / cfg.output_dim).abs().max()) < 1e-9,
           "spectral kernel: non-finite output or no uniform fallback")

    rings1 = rings[:1].contiguous()
    got = ring_kernel.project_rings_cuda(rings1, proj, rows)
    _check(torch.equal(got, project_rings_batch_plain(rings1, proj, rows)),
           "ring kernel != plain version at B=1")
    _spectral_shapes(gen)
    _edge_cases(device)

    # per kernel at B=8 (and B=1): wrapper, kernel alone, plain, bound
    pix_bytes = 4 * cfg.n_elevation * cfg.n_azimuth
    n_out = cfg.target_elevation_bins * cfg.n_bins
    imgs1 = imgs[:1].contiguous()
    gen1 = gen[:1].contiguous()
    serving = {
        "project": (lambda x: (lambda: projection_kernel.project_points_cuda(
            x, proj)), lambda: project_points_batch_plain(gen, proj),
            gen, gen1, lambda x: _bound(4 * x.numel()
                                        + pix_bytes * x.shape[0])),
        "ring_fold": (lambda x: (lambda: ring_kernel.project_rings_cuda(
            x, proj, rows)), lambda: project_rings_batch_plain(
                rings, proj, rows), rings, rings1,
            lambda x: _bound(4 * x.numel() + pix_bytes * x.shape[0])),
        "spectral": (lambda x: (lambda: spectral_kernel.encode_images_cuda(
            x, alpha, cfg)), lambda: encode_images_plain(imgs, alpha, cfg),
            imgs, imgs1, lambda x: _bound(4 * x.numel() + 4 * n_out
                                          * x.shape[0],
                                          _spectral_ops(x, cfg))),
    }
    _only_kernel("spectral", serving["spectral"][0](imgs))
    _only_kernel("ring_fold", serving["ring_fold"][0](rings))
    _only_kernel("project", serving["project"][0](gen))
    timing = {}
    for name, (call, plain, x8, x1, bound) in serving.items():
        bound_ms, bound_by = bound(x8)
        b1 = _device_times(name, call(x1))
        wrapper_ms = _time_ms(call(x8))
        timing[name] = {"ms": wrapper_ms, "wrapper_ms": wrapper_ms,
                        "plain_ms": _time_ms(plain),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "bound_ms_b1": bound(x1)[0],
                        "device_ms_b1": b1["device_ms"],
                        "queued_ms_b1": b1["queued_ms"],
                        **_device_times(name, call(x8))}
        t = timing[name]
        print(f"kernel {name}: B={BATCH} device {t['device_ms']:.5f} ms "
              f"(profiler {t['profiler_ms']}, queued bare "
              f"{t['queued_ms']:.5f}), wrapper {t['wrapper_ms']:.5f} ms, "
              f"plain {t['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}); B=1 device {t['device_ms_b1']:.5f} ms "
              f"(queued bare {t['queued_ms_b1']:.5f}), bound "
              f"{t['bound_ms_b1']:.5f} ms", flush=True)
    sweep1 = sweep[:1].contiguous()
    for key, x in (("sweep", sweep), ("sweep_b1", sweep1)):
        t = _device_times("project", serving["project"][0](x))
        timing["project"][f"device_ms_{key}"] = t["device_ms"]
        timing["project"][f"queued_ms_{key}"] = t["queued_ms"]
    t = timing["project"]
    print(f"kernel project, sweep order: B={BATCH} device "
          f"{t['device_ms_sweep']:.5f} ms (queued bare "
          f"{t['queued_ms_sweep']:.5f}), B=1 device "
          f"{t['device_ms_sweep_b1']:.5f} ms (queued bare "
          f"{t['queued_ms_sweep_b1']:.5f})", flush=True)
    timing.update(_probe_kernels(device))

    # -- 4. serve ----------------------------------------------------------
    rng = np.random.default_rng(SEED + 4)
    ring_req = make_structured_ring_scans(N_REQUESTS // 2, N_RINGS, PER_RING,
                                          proj, seed=SEED + 5)
    gen_req = _general_scans(N_REQUESTS // 2, SEED + 6)
    requests = [(ring_req[j // 2], rows) if j % 2 == 0
                else (gen_req[j // 2], None) for j in range(N_REQUESTS)]

    t0 = time.perf_counter()
    cpu_desc = torch.stack([encode_scan(torch.from_numpy(p), alpha, cfg, r)
                            for p, r in requests])
    print(f"serve: CPU plain descriptors of {N_REQUESTS} scans in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    desc0 = rng.random((N_NODES, cfg.output_dim)).astype(np.float32) ** 4
    desc0 /= desc0.sum(axis=1, keepdims=True)
    poses = np.tile(np.eye(4), (N_NODES, 1, 1))
    poses[:, 0, 3] = np.arange(N_NODES) * 2.0        # straight line, 2 m
    loops = [(i, i + 500) for i in range(0, 500, 25)]
    graph_np = build_graph(desc0, poses, loop_closures=loops)
    graph = graph_to_tensors(graph_np, device)
    graph_cpu = graph_to_tensors(graph_np, "cpu")

    model_cpu = SpectralGNN(generator=torch.Generator().manual_seed(SEED))
    model_cpu.eval()
    model = copy.deepcopy(model_cpu).to(device).eval()

    centers = [100 + 25 * j for j in range(N_REQUESTS)]
    qps = [np.array([poses[c, 0, 3], 0.0, 0.0, MIN_DIST], np.float32)
           for c in centers]
    ret = WassersteinRetriever(n_bins=cfg.output_dim,
                               capacity=DB_ROWS + N_REQUESTS, device=device)
    gdb = torch.Generator(device=device).manual_seed(SEED + 7)
    planted = (np.arange(N_REQUESTS) * 3121 + 17) % DB_ROWS
    chunk = 10_000
    for lo in range(0, DB_ROWS, chunk):
        h = torch.rand((chunk, cfg.output_dim), generator=gdb,
                       device=device) ** 4
        pos = (torch.rand((chunk, 3), generator=gdb, device=device)
               - 0.5) * 20_000.0
        for j in np.flatnonzero((planted >= lo) & (planted < lo + chunk)):
            h[planted[j] - lo] = cpu_desc[j].to(device)
            pos[planted[j] - lo] = torch.from_numpy(
                qps[j][:3] + np.array([5 * MIN_DIST, 0, 0], np.float32))
        ret.add_to_database(h, pos)
    torch.cuda.synchronize()
    print(f"serve: database {ret.database_size} rows x {cfg.output_dim} "
          f"float32 ({ret.database_size * cfg.output_dim * 4 / 1e6:.0f} MB) "
          f"on {device}", flush=True)

    # warm-up requests (no insert; not counted, not timed)
    for p, r in requests[:2]:
        serve_step(ret, model, torch.from_numpy(p).to(device), alpha, graph,
                   0, torch.from_numpy(qps[0]).to(device), TOP_K,
                   do_insert=False, config=cfg, row_of_ring=r)
    graph = graph_to_tensors(graph_np, device)
    torch.cuda.synchronize()

    kernels = _all_kernels()
    for k in kernels.values():
        k.launches = 0
    lat_ms, results = [], []
    for j, (p, r) in enumerate(requests):
        qp = torch.from_numpy(qps[j]).to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()            # the scan arrives on the host
        pts = torch.from_numpy(p).to(device)
        desc, emb, idx, dist = serve_step(
            ret, model, pts, alpha, graph, centers[j], qp, TOP_K,
            do_query=True, do_insert=True, config=cfg, row_of_ring=r)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        results.append((desc.cpu(), emb.cpu(), idx.cpu(), dist.cpu()))
    launches = {n: k.launches for n, k in kernels.items()}
    print(f"serve: {N_REQUESTS} requests, latency p50 "
          f"{statistics.median(lat_ms):.3f} ms, max {max(lat_ms):.3f} ms, "
          f"launches {launches}", flush=True)

    desc_err = emb_err = 0.0
    for j, (desc, emb, idx, dist) in enumerate(results):
        _check(int(idx[0]) == int(planted[j]),
               f"request {j}: top-1 {int(idx[0])} != planted row "
               f"{int(planted[j])} (dist {dist[:3].tolist()})")
        _check(bool(torch.all(torch.isfinite(desc))) and
               bool(torch.all(torch.isfinite(emb))), f"request {j}: "
               "non-finite output")
        desc_err = max(desc_err, float((desc - cpu_desc[j]).abs().max()))
        graph_cpu.features[centers[j]] = cpu_desc[j]
        with torch.no_grad():
            emb_cpu = model_cpu(graph_cpu.features, graph_cpu.neighbors,
                                graph_cpu.mask, graph_cpu.edge_feats)
        emb_err = max(emb_err, float((emb - emb_cpu).abs().max()))
    print(f"serve: top-1 planted row on {N_REQUESTS}/{N_REQUESTS}; "
          f"descriptor max abs err vs CPU {desc_err:.3e}, embedding "
          f"{emb_err:.3e}", flush=True)
    _check(desc_err <= DESC_TOL, f"descriptors differ from the CPU path by "
           f"{desc_err:.3e} > {DESC_TOL}")
    _check(emb_err <= EMB_TOL, f"embeddings differ from the CPU path by "
           f"{emb_err:.3e} > {EMB_TOL}")
    _check(all(launches[k] > 0 for k in ("spectral", "ring_fold", "project")),
           f"a kernel of the path never launched: {launches}")
    by_path = {"serve": launches}

    # -- 5. the stage-profile entry points ---------------------------------
    by_path.update(_probe_paths())

    # -- 6. structured-scan entry point ------------------------------------
    by_path["structured"] = _structured(device)

    # -- 7. training -------------------------------------------------------
    _train_step_vs_cpu(device)
    by_path.update(_train_entry(device))
    _scale(device)

    # -- 8. the online loop ------------------------------------------------
    by_path["online"] = _online(device)

    # -- 9. record ---------------------------------------------------------
    meta = {
        "spectral": ("neural_spectral_codec_torch/csrc/spectral.cu",
                     "neural_spectral_codec_tpu/ops/pallas_spectral.py:169",
                     spec_err),
        "ring_fold": ("neural_spectral_codec_torch/csrc/ring_fold.cu",
                      "neural_spectral_codec_tpu/ops/pallas_ring.py:248",
                      ring_err),
        "project": ("neural_spectral_codec_torch/csrc/project.cu",
                    "neural_spectral_codec_tpu/ops/pallas_compact.py:142",
                    proj_err),
        "ring_probe": ("neural_spectral_codec_torch/csrc/ring_probe.cu",
                       "experiments/ring_stage_probe.py:163",
                       timing["ring_probe"]["max_abs_err"]),
        "roll_floor": ("neural_spectral_codec_torch/csrc/roll_floor.cu",
                       "experiments/ring_stage_probe.py:200",
                       timing["roll_floor"]["max_abs_err"]),
        "roll_min_chain": ("neural_spectral_codec_torch/csrc/roll_floor.cu",
                           "experiments/profile_hotpath.py:254",
                           timing["roll_min_chain"]["max_abs_err"]),
    }
    # "ms" keeps the meaning it had in earlier records: the wrapper's time
    # per call (one event pair per call; for the probes, loops of 200 calls)
    record = []
    for name, (source, replaces, err) in meta.items():
        t = timing[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(v[name] for v in by_path.values()),
                 "launches_by_path": {p: v[name] for p, v in by_path.items()},
                 "max_abs_err": err, "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": None,
                 "library_note": NO_LIBRARY[name],
                 "device_ms": t["device_ms"], "wrapper_ms": t["wrapper_ms"],
                 "profiler_ms": t["profiler_ms"],
                 "queued_ms": t["queued_ms"]}
        for key in ("device_ms_b1", "queued_ms_b1", "bound_ms_b1",
                    "device_ms_sweep", "queued_ms_sweep",
                    "device_ms_sweep_b1", "queued_ms_sweep_b1",
                    "device_ms_cold", "device_ms_cold_b1"):
            if key in t:
                entry[key] = t[key]
        if name == "project":
            entry["also_replaces"] = \
                "neural_spectral_codec_tpu/ops/pallas_densify.py:76"
        record.append(entry)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
