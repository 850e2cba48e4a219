"""Phase costs of the Hopper ring kernel, measured by switching phases off.

    python -m neural_spectral_codec_torch.experiments.ring_stage_probe \
        [--iters 200] [--rounds 9] [--batch 8] [--out record.json]

Counterpart of the JAX repository's ``experiments/ring_stage_probe.py``,
which switched off the TPU ring kernel's six stage classes one at a time.
Here the probed kernel is the port's fold on precomputed keys
(``ops.probe_kernels.ring_fold_probe``, ``csrc/ring_probe.cu``), built as
``csrc/ring_fold.cu`` is: each thread summarises a contiguous chunk of the
row as {first valid bin, last valid bin, wrap events}, one exclusive scan
(warp shuffles, then across warps) gives every chunk its start, and the
kept ranges go to a shared-memory row by ``atomicMin``. Its phases:
``scan`` (the first/last half of the summary; off: every chunk starts
after bin −1), ``fold`` (the wrap-event half; off: every chunk starts at
fold 0), ``scatter`` (the ``atomicMin``; off: a plain store), ``write``
(+inf → 0 on the way out; off: an integer clamp). A phase's cost is the
full kernel's time minus the time of the variant without it, taken in
rounds (every variant in turn, ``--rounds`` times, after a warm-up) as
the median over rounds of the difference within a round, with its
quartiles; the variant with every phase off is the kernel's skeleton
(the row loads, the row init, the store). Floors from the roll + compare
+ select kernel (``roll_floor``) give the unit each phase is expressed
in, matched to the TPU classes it replaces (``REPLACES``): ``scan``
(the jump-fill) and ``fold`` (fold index, rank prefix) against 12 stages
over 1 array (p = 2176), ``scatter`` (run-min, compaction) against 12
stages over 2 arrays, ``write`` against 10 stages over 2 arrays at the
folded row's width (w = 768), where the TPU's expansion worked. On the
TPU a floor was 10-12 roll stages; on Hopper it is one windowed pass over
a row of the same width (the chain's function, the first minimum of a
circular window, ``csrc/roll_floor.cu``), so a ratio says how a phase
compares with one such pass, not with a number of stages.

Input: ``make_structured_ring_scans`` at B scans of 64 rings × 2088
points, keys from ``ops.ring_path._ring_keys`` padded to 2176 with key −1
and range +inf (``ops.probe_kernels.ring_keys_padded``), n_folds = 2.
Before timing, the full variant must equal ``ring_fold_rows_plain`` bit
for bit, and after the min over folds (``fold_min_rows``) and the row
placement ``project_rings_cuda``'s image. Times: each kernel's own
device time, CUDA events around ``--iters`` launches of its C entry point
(``CudaKernel.bare``, on the arguments of one wrapper call) queued behind
a spin kernel (``utils.timing.time_queued_ms``), so that no wrapper's
host time (30-60 µs a call against kernels of a few µs) enters. Stage
counts are the full depths: the TPU's host-certified bounds are not
ported. Prints its record as JSON and a markdown table; writes a file
only under ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import numpy as np
import torch

from neural_spectral_codec_torch.device import resolve_device
from neural_spectral_codec_torch.ops.probe_kernels import (
    PHASES, REPLACES, RING_PROBE, ROLL_FLOOR, fold_min_rows, folded_width,
    ring_fold_probe, ring_fold_rows_plain, ring_keys_padded, roll_floor)
from neural_spectral_codec_torch.ops.range_image import ProjectionConfig
from neural_spectral_codec_torch.ops.ring_kernel import KERNEL as RING_KERNEL
from neural_spectral_codec_torch.ops.ring_kernel import project_rings_cuda
from neural_spectral_codec_torch.ops.ring_path import (
    make_structured_ring_scans)
from neural_spectral_codec_torch.utils.timing import gpu_label, time_queued_ms

N_RINGS, PER_RING = 64, 2088
N_FOLDS = 2
# floor kernel per phase: (stages, arrays, width), after the TPU classes
# each phase replaces: the scan half of the summary the jump-fill and the
# fold half the rank prefix (1-array chains over the ring); the scatter
# run-min and compaction (2-array chains); the write works at the folded
# row's width, as the expansion did (2 arrays over 768)
FLOORS = {"floor_12stage_1array": (12, 1, "p"),
          "floor_12stage_2array": (12, 2, "p"),
          "floor_10stage_2array_w768": (10, 2, "w")}
MATCHED_FLOOR = {"scan": "floor_12stage_1array",
                 "fold": "floor_12stage_1array",
                 "scatter": "floor_12stage_2array",
                 "write": "floor_10stage_2array_w768"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=200,
                    help="launches per timed loop")
    ap.add_argument("--rounds", type=int, default=9,
                    help="rounds of the variants in turn")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON record here")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    label = gpu_label()
    config = ProjectionConfig()
    n_azim, b = config.n_azimuth, args.batch
    scans = torch.from_numpy(make_structured_ring_scans(
        b, N_RINGS, PER_RING, config, seed=0)).to(device)
    key, vals = ring_keys_padded(scans, config)
    ppad, wpad = key.shape[1], folded_width(n_azim, N_FOLDS)

    folded = ring_fold_probe(key, vals, n_azim, N_FOLDS)
    if not torch.equal(folded, ring_fold_rows_plain(key, vals, n_azim,
                                                    N_FOLDS)):
        raise RuntimeError("ring_stage_probe: the full variant differs from "
                           "ring_fold_rows_plain")
    image = project_rings_cuda(scans, config, tuple(range(N_RINGS)), N_FOLDS)
    if not torch.equal(fold_min_rows(folded, b, N_RINGS, n_azim, N_FOLDS),
                       image):
        raise RuntimeError("ring_stage_probe: the full variant's rows differ "
                           "from project_rings_cuda's image")

    keep = []        # outputs of the wrapper calls the bare launches reuse

    def bare(call, kernel):
        """The C entry point alone on the arguments of one wrapper call:
        timed queued (``time_queued_ms``), its launches carry no host
        time (a wrapper call costs 30-60 µs of it, the kernel a few)."""
        keep.append(call())
        return kernel.bare()

    def timed(fn):
        return time_queued_ms(fn, n=args.iters)

    variants = {"full": bare(lambda: ring_fold_probe(key, vals, n_azim,
                                                     N_FOLDS), RING_PROBE)}
    for skip in [(ph,) for ph in PHASES] + [PHASES]:
        name = "minus_all" if len(skip) > 1 else f"minus_{skip[0]}"
        variants[name] = bare(lambda skip=skip: ring_fold_probe(
            key, vals, n_azim, N_FOLDS, skip=skip), RING_PROBE)
    for _ in range(20 * args.iters):           # bring the clocks up
        variants["full"]()
    # the variants in turn, round after round: a phase's cost is the
    # median over rounds of (full - variant) within one round, so drift
    # between rounds cancels
    samples = {name: [] for name in variants}
    for _ in range(args.rounds):
        for name, fn in variants.items():
            samples[name].append(time_queued_ms(fn, n=args.iters, repeats=1))
    ms = {name: statistics.median(v) for name, v in samples.items()}
    ms["ring_fold_cu"] = timed(bare(lambda: project_rings_cuda(
        scans, config, tuple(range(N_RINGS)), N_FOLDS), RING_KERNEL))
    rng = np.random.default_rng(0)
    arrays = {}
    for w in (ppad, wpad):
        x = torch.from_numpy(rng.uniform(0, 1, (key.shape[0], w)).astype(
            np.float32)).to(device)
        arrays[w] = (x, x + 1.0)
    for name, (stages, n_arrays, which) in FLOORS.items():
        x, y = arrays[ppad if which == "p" else wpad]
        ms[name] = timed(bare(lambda x=x, y=y, s=stages, a=n_arrays:
                              roll_floor(x, y, s, a), ROLL_FLOOR))

    us = {k: 1e3 * v / b for k, v in ms.items()}

    def paired(name):
        """Median and quartiles of full - variant over rounds, µs/scan."""
        d = [1e3 * (f - v) / b for f, v in zip(samples["full"],
                                                 samples[name])]
        q = statistics.quantiles(d, n=4) if len(d) > 1 else d * 3
        return statistics.median(d), q[0], q[2]

    cost = {ph: paired(f"minus_{ph}") for ph in PHASES}
    all_phases = paired("minus_all")
    record = {
        "device": torch.cuda.get_device_name(device), "gpu": label,
        "batch": b, "iters": args.iters, "rounds": args.rounds, "p": ppad,
        "wpad": wpad, "n_folds": N_FOLDS, "us_per_scan": us,
        "phase_cost_us": {ph: c[0] for ph, c in cost.items()},
        "phase_cost_quartiles_us": {ph: [c[1], c[2]]
                                    for ph, c in cost.items()},
        "all_phases_us": all_phases[0],
        "all_phases_quartiles_us": [all_phases[1], all_phases[2]],
        "matched_floor": MATCHED_FLOOR,
        "matched_floor_ratio": {ph: cost[ph][0] / us[MATCHED_FLOOR[ph]]
                                for ph in PHASES},
        "replaces": {ph: list(REPLACES[ph]) for ph in PHASES},
    }
    print(json.dumps(record), flush=True)
    print(f"\nring fold phases, {label}, B={b}, µs/scan, medians of "
          f"{args.rounds} rounds: full {us['full']:.3f}; every phase off "
          f"{us['minus_all']:.3f} (all phases {all_phases[0]:.3f}, "
          f"quartiles {all_phases[1]:.3f} .. {all_phases[2]:.3f}); "
          f"ring_fold.cu with keys from xyz {us['ring_fold_cu']:.3f}\n")
    print("| phase | replaces (TPU classes) | cost µs/scan (quartiles) | "
          "matched floor (one windowed pass) | floor µs/scan | ratio |")
    print("|---|---|---|---|---|---|")
    for ph in PHASES:
        fl = MATCHED_FLOOR[ph]
        c, lo, hi = cost[ph]
        print(f"| {ph} | {', '.join(REPLACES[ph]) or '—'} | {c:.3f} "
              f"({lo:.3f} .. {hi:.3f}) | {fl} | {us[fl]:.3f} | "
              f"{record['matched_floor_ratio'][ph]:.2f}x |", flush=True)
    if args.out is not None:
        args.out.write_text(json.dumps(record, indent=2))
    return record


if __name__ == "__main__":
    main()
