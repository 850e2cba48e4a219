"""This tree's CUDA kernels against another build of the same C entry
points, on the same card, in turns.

    python -m neural_spectral_codec_torch.experiments.kernel_ab \\
        --other-csrc DIR [--json out.json]

``DIR`` holds another version of ``csrc/`` (for example a parent
commit's, unpacked with ``git archive <commit> neural_spectral_codec_torch/csrc``).
It is compiled with ``_build.NVCC_FLAGS`` into a second library beside
this tree's. Each serving kernel (K1 at B=8 and B=1, K2 at B=8 and B=1,
K3 at B=8 and B=1 on random-order scans) and the ring-fold probe (P1 at
the probe shape) is called once through its wrapper; then both libraries'
entry points are launched on those same arguments, bare and queued behind
a spin kernel (``utils.timing.time_queued_ms``, 200 launches), in the
order other, this, this, other, twice. Prints and returns each side's
median device µs. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch


def build_other(csrc: Path, out_dir: Path) -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` with this tree's flags into one library."""
    from neural_spectral_codec_torch import _build
    nvcc = _build.find_nvcc()
    objs = [out_dir / f"{cu.stem}.o" for cu in sorted(csrc.glob("*.cu"))]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o),
                               str(cu)])
             for cu, o in zip(sorted(csrc.glob("*.cu")), objs)]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError(f"nvcc failed on {csrc}")
    lib = out_dir / "libother.so"
    subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", str(lib),
                    *map(str, objs)], check=True)
    return ctypes.CDLL(str(lib))


def _scans(n: int, n_points: int, seed: int) -> np.ndarray:
    """Random-order full-view scans with ranges on both sides of the
    gates (``chip_smoke._general_scans`` without the NaN tails)."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, (n, n_points))
    el = rng.uniform(np.deg2rad(-26.0), np.deg2rad(3.0), (n, n_points))
    r = rng.uniform(0.5, 90.0, (n, n_points))
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el), rng.uniform(0, 1, r.shape)],
                    axis=-1).astype(np.float32)


def run(other_csrc: str, log=print) -> dict:
    from neural_spectral_codec_torch import _build, resolve_device
    from neural_spectral_codec_torch.ops import (
        probe_kernels, projection_kernel, ring_kernel, spectral_kernel)
    from neural_spectral_codec_torch.ops.range_image import (
        project_points_batch_plain)
    from neural_spectral_codec_torch.ops.ring_path import (
        make_structured_ring_scans)
    from neural_spectral_codec_torch.ops.spectral import SpectralEncoderConfig
    from neural_spectral_codec_torch.utils.timing import (
        gpu_label, time_queued_ms)

    dev = resolve_device("cuda")
    log(gpu_label())
    other = build_other(Path(other_csrc), Path(tempfile.mkdtemp()))
    _build.load_library()
    cfg = SpectralEncoderConfig()
    proj = cfg.projection
    rows = tuple(range(64))
    gen = torch.from_numpy(_scans(8, 64 * 2088, 1)).to(dev)
    rings = torch.from_numpy(make_structured_ring_scans(
        8, 64, 2088, proj, seed=2)).to(dev)
    imgs = project_points_batch_plain(gen, proj)
    key, vals = probe_kernels.ring_keys_padded(rings, proj)
    cases = {
        "spectral_b8": (spectral_kernel.KERNEL,
                        lambda: spectral_kernel.encode_images_cuda(
                            imgs, cfg.alpha, cfg)),
        "spectral_b1": (spectral_kernel.KERNEL,
                        lambda: spectral_kernel.encode_images_cuda(
                            imgs[:1].contiguous(), cfg.alpha, cfg)),
        "ring_fold_b8": (ring_kernel.KERNEL,
                         lambda: ring_kernel.project_rings_cuda(
                             rings, proj, rows)),
        "ring_fold_b1": (ring_kernel.KERNEL,
                         lambda: ring_kernel.project_rings_cuda(
                             rings[:1].contiguous(), proj, rows)),
        "project_b8": (projection_kernel.KERNEL,
                       lambda: projection_kernel.project_points_cuda(
                           gen, proj)),
        "project_b1": (projection_kernel.KERNEL,
                       lambda: projection_kernel.project_points_cuda(
                           gen[:1].contiguous(), proj)),
        "ring_probe_b8": (probe_kernels.RING_PROBE,
                          lambda: probe_kernels.ring_fold_probe(
                              key, vals, proj.n_azimuth, 2)),
    }
    out = {}
    for name, (kernel, call) in cases.items():
        keep = call()            # the wrapper's arguments stay alive
        torch.cuda.synchronize()
        args = kernel.last_args
        fn = getattr(other, kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int

        def launch_other():
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"{kernel.symbol} (other): CUDA error "
                                   f"{err}")
        sides = {"other": launch_other, "this": kernel.bare()}
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other") * 2:
            times[side].append(1e3 * time_queued_ms(sides[side], n=200))
        out[name] = {"other_us": statistics.median(times["other"]),
                     "this_us": statistics.median(times["this"]),
                     "runs_us": times}
        log(f"{name}: other {out[name]['other_us']:.3f} µs, this "
            f"{out[name]['this_us']:.3f} µs")
        del keep
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-csrc", required=True)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = run(args.other_csrc)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
