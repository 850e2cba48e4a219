"""Stage-by-stage profile of the encode hot path on the card.

    python -m neural_spectral_codec_torch.experiments.profile_hotpath \
        [--iters 30]

Counterpart of the JAX repository's ``experiments/profile_hotpath.py``,
line for line in its order, at B = 8 full-density HDL-64E scans (64
rings × 2088 points, the JAX script's fixed batch): the ring and general
paths end to end, the ring projection, the spherical + key math alone,
the fold kernel alone on precomputed keys (``ring_fold_probe``), the
general path's spherical + key packing alone, the TPU path's sorts on the
same packed keys (packed one-key sort, one fused batch sort;
``torch.sort``, which the port's atomics design does without), the roll +
min chain (``roll_min_chain``, 64 stages over 512 × 2112 lanes) and the
key-only sort. The TPU script reads the chain as a per-stage floor (its
time over 64); the Hopper kernel computes the chain's function, a
circular window min, in one pass over the row and walks no stage, so the
port prints the call's µs and no per-stage rate.

Times: CUDA events around loops of ``--iters`` calls, median of 5 loops
(``utils.timing.time_loop_ms``). Eager CUDA hoists nothing, so the JAX
script's two-point timing and feedback loops have no counterpart. Stages
that are not kernels of the port (keys, key packing, sorts) run as plain
PyTorch on the card. Prints one line per stage and returns them. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from neural_spectral_codec_torch.device import resolve_device
from neural_spectral_codec_torch.ops.probe_kernels import (
    ring_fold_probe, ring_keys_padded, roll_min_chain)
from neural_spectral_codec_torch.ops.range_image import (
    _spherical, _valid_mask, azimuth_bins, elevation_bins)
from neural_spectral_codec_torch.ops.ring_path import (
    _ring_keys, encode_points_ring_batch, make_structured_ring_scans,
    project_rings_batch)
from neural_spectral_codec_torch.ops.spectral import (
    SpectralEncoderConfig, encode_points_batch)
from neural_spectral_codec_torch.utils.timing import gpu_label, time_loop_ms

B = 8
N_RINGS, PER_RING = 64, 2088
ROLL_STAGES, ROLL_WIDTH = 64, 2112


def _quant_bits(n_pix: int) -> int:
    """Low bits of the packed int31 sort key left for the quantised range
    (copied from JAX ``range_image._quant_bits``, range_image.py:133)."""
    id_bits = (n_pix + 1).bit_length()
    if id_bits > 31:
        raise ValueError(f"image with {n_pix} pixels exceeds int32 sort keys")
    return min(16, 31 - id_bits)


def _batch_key_layout(b: int, n_pix: int):
    """(id_bits, batch_bits, quant_bits) of the fused batch-sort key
    (copied from JAX ``range_image._batch_key_layout``,
    range_image.py:182)."""
    id_bits = (n_pix + 1).bit_length()
    bb = max(b - 1, 0).bit_length()
    return id_bits, bb, min(16, 31 - id_bits - bb)


def random_scans(batch: int, seed: int = 0) -> np.ndarray:
    """Arbitrary-order scans of 64 × 2088 points inside the gates (the
    JAX profile's general-path input)."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, (batch, N_RINGS * PER_RING))
    el = rng.uniform(np.deg2rad(-24.8), np.deg2rad(2.0), az.shape)
    r = rng.uniform(2.0, 70.0, az.shape)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el), rng.uniform(0, 1, az.shape)],
                    axis=2).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30,
                    help="calls per timed loop")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = SpectralEncoderConfig()
    proj = cfg.projection
    rows = tuple(range(N_RINGS))
    n_pix = proj.n_elevation * proj.n_azimuth
    n_pts = N_RINGS * PER_RING
    ring_scans = torch.from_numpy(make_structured_ring_scans(
        B, N_RINGS, PER_RING, proj, seed=0)).to(device)
    rand_scans = torch.from_numpy(random_scans(B)).to(device)
    print(f"profile_hotpath: {gpu_label()}, B={B}, {n_pts} points per scan",
          flush=True)

    lines = {}

    def line(name, fn, extra=lambda ms: ""):
        ms = time_loop_ms(fn, n=args.iters)
        lines[name] = 1e3 * ms / B
        print(f"{name:<30}: {lines[name]:9.3f} us/scan{extra(ms)}",
              flush=True)
        return ms

    per_elem = lambda ms: f" ({ms * 1e6 / (B * n_pts):.3f} ns/elem)"
    rate = lambda ms: f" ({B / (ms * 1e-3):,.0f} scans/s)"

    line("ring path end-to-end", lambda: encode_points_ring_batch(
        ring_scans, cfg.alpha, cfg, rows), rate)
    line("general path end-to-end", lambda: encode_points_batch(
        rand_scans, cfg.alpha, cfg), rate)
    line("  ring: projection only", lambda: project_rings_batch(
        ring_scans, proj, rows))
    line("  ring: spherical+keys only", lambda: _ring_keys(ring_scans, proj))
    key, vals = ring_keys_padded(ring_scans, proj)
    line("  ring: fold kernel only", lambda: ring_fold_probe(
        key, vals, proj.n_azimuth, 2))

    def keypack(x):
        rng_, azim, elev, finite = _spherical(x)
        valid = _valid_mask(rng_, elev, finite, proj)
        li = torch.where(valid, elevation_bins(elev, proj) * proj.n_azimuth
                         + azimuth_bins(azim, proj.n_azimuth), n_pix)
        return li.to(torch.int32), torch.where(valid, rng_, math.inf)

    line("  gen: spherical+keypack only", lambda: keypack(rand_scans))
    li, v = keypack(rand_scans)
    qb = _quant_bits(n_pix)
    qmax = (1 << qb) - 1
    quant = torch.clamp(v * (qmax / proj.max_range), 0, qmax).to(torch.int32)
    packed = (li << qb) | quant

    def sort_with_payload(k, val):
        k2, order = torch.sort(k, dim=-1)
        return k2, torch.gather(val, -1, order)

    line("  gen: packed 1-key sort only", lambda: sort_with_payload(
        packed, v), per_elem)
    id_bits, _, qb2 = _batch_key_layout(B, n_pix)
    bid = torch.arange(B, dtype=torch.int32, device=device)[:, None]
    packed_b = ((bid << (id_bits + qb2)) | (li << qb2)
                | (quant >> (qb - qb2))).reshape(-1)
    line("  gen: ONE fused batch sort", lambda: sort_with_payload(
        packed_b, v.reshape(-1)), per_elem)

    xroll = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (B * N_RINGS, ROLL_WIDTH)).astype(np.float32)).to(device)
    ms = time_loop_ms(lambda: roll_min_chain(xroll, ROLL_STAGES),
                      n=args.iters)
    lines["roll+min chain us/call"] = ms * 1e3
    print(f"{'  roll+min chain':<30}: {ms * 1e3:9.3f} us/call "
          f"({ROLL_STAGES} stages over {B * N_RINGS} x {ROLL_WIDTH}, one "
          f"windowed pass)", flush=True)
    line("  gen: key-ONLY sort", lambda: torch.sort(packed, dim=-1), per_elem)
    return lines


if __name__ == "__main__":
    main()
