"""Per-keyframe latency of the online loop (``run_online``) on one device:
the port of ``experiments/online_latency.py``.

    python -m neural_spectral_codec_torch.experiments.online_latency \\
        [--frames 400] [--n-points 16384] [--async] [--no-fused-query] \\
        [--device cuda] [--json out.json]

The configuration is ``configs/inference.yaml`` over ``default.yaml``
(``INFERENCE_CONFIG``, built in code so that no YAML reader is needed),
with the spatial filter off (with ground-truth poses its 50 m radius
excludes every true revisit) and the synthetic stream in place of a
dataset. The frames are generated before the run, and a wrapper loader
stamps each fetch on the host clock: the gap between fetch i and fetch
i + 1 is the loop's time for scan i (the last scan has none). Keyframe
scans are reported apart from pass-through scans, and the first
``--warmup-scans`` scans apart from the rest; the count of keyframes over
the 100 ms budget and the profiler's stage means (ms per call, the device
synchronised at each device stage) complete the report.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# configs/inference.yaml over default.yaml: the sections the online
# pipeline reads (tests/test_torch_online_latency.py holds them to the files)
INFERENCE_CONFIG = {
    "encoding": {"n_elevation": 16, "n_azimuth": 360,
                 "elevation_range": [-24.8, 2.0], "max_range": 80.0,
                 "min_range": 1.0, "elevation_mode": "clip",
                 "target_elevation_bins": 16, "n_bins": 50, "alpha": 2.0,
                 "epsilon": 1e-8, "interpolate_empty": True,
                 "ring_major": False, "max_points": 131072},
    "keyframe": {"distance_threshold": 0.5, "rotation_threshold": 15.0,
                 "overlap_threshold": 0.7, "temporal_threshold": 5.0,
                 "voxel_size": 0.2, "max_keyframes": 100000,
                 "temporal_neighbors": 5, "max_active_nodes": 1000,
                 "freeze_old_embeddings": True},
    "gnn": {"input_dim": 800, "hidden_dim": 256, "output_dim": 800,
            "n_layers": 3, "dropout": 0.1, "residual": True, "edge_dim": 2,
            "local_update_hops": 3, "use_local_updates": True},
    "retrieval": {"use_embeddings": False, "top_k": 10,
                  "spatial_filter_distance": 50.0, "context_window": 10,
                  "use_wasserstein": True, "storage": "float32",
                  "verification_method": "gicp",
                  "icp_fitness_threshold": 0.3, "icp_rmse_threshold": 0.5,
                  "icp_max_iterations": 30, "voxel_downsample": 0.3,
                  "database_capacity": 100000,
                  "parallel_verification": True, "verification_workers": 8},
    "deployment": {"max_latency_ms": 100, "loop_closing_interval": 10,
                   "batch_size": 256, "warmup": True,
                   "async_loop_closing": True, "fused_encode": True,
                   "fused_query": True},
    "database": {"max_database_size": 100000, "autosave_interval": 0},
    "loop_closing": {"min_loop_distance": 50.0, "output_format": "g2o"},
    "monitoring": {"enabled": True, "log_interval": 100,
                   "metrics": ["encoding_time", "query_time", "icp_time",
                               "total_time", "memory_usage",
                               "database_size"]},
    "system": {"seed": 42},
    "parallel": {"shard_retrieval_db": False},
}
STAGES = ("select", "serve_step", "encode_graph_update", "encode",
          "graph_update", "retrieval_add", "loop_closing",
          "loop_closing_submit", "verification", "db_autosave")


def inference_config(**sections) -> Dict:
    """A copy of ``INFERENCE_CONFIG`` with the spatial filter off and the
    given sections updated."""
    cfg = copy.deepcopy(INFERENCE_CONFIG)
    cfg["retrieval"]["spatial_filter_distance"] = 0.0
    for k, v in sections.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


class TimedLoader:
    """Preloaded frames; each fetch is stamped on the host clock, so the
    gap between fetch i and fetch i + 1 is the loop's time for scan i."""

    def __init__(self, frames):
        self.frames = list(frames)
        self.fetch_times = []

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        self.fetch_times.append(time.perf_counter())
        return self.frames[idx]


def latency_report(loader: TimedLoader, pipe, warmup_scans: int,
                   budget_ms: float) -> Dict:
    """Per-scan gaps in ms, split into keyframe / pass-through and
    warm-up / steady scans: p50, p95, max, count, and the keyframes over
    the budget after warm-up."""
    gaps = np.diff(np.asarray(loader.fetch_times)) * 1e3
    is_kf = np.zeros(len(gaps), bool)
    for kf in pipe.selector.keyframes:
        if kf.scan_id < len(gaps):
            is_kf[kf.scan_id] = True
    steady = np.arange(len(gaps)) >= warmup_scans

    def stats(x):
        if len(x) == 0:
            return {"n": 0}
        return {"n": int(len(x)), "p50_ms": float(np.percentile(x, 50)),
                "p95_ms": float(np.percentile(x, 95)),
                "max_ms": float(x.max())}

    kf_steady = gaps[is_kf & steady]
    return {"keyframe": stats(kf_steady),
            "passthrough": stats(gaps[~is_kf & steady]),
            "warmup_scans": stats(gaps[~steady]),
            "keyframes_over_budget": int((kf_steady > budget_ms).sum()),
            "budget_ms": budget_ms,
            "stage_mean_ms": {k: v for k, v in pipe.profiler.means_ms().items()
                              if k in STAGES},
            "stage_calls": {k: int(pipe.profiler.counts[k])
                            for k in pipe.profiler.counts if k in STAGES},
            **{name: int(pipe.profiler.events.get(name, 0)) for name in (
                "midstream_captures", "query_midstream_captures",
                "serving_replays", "eval_replays")}}


def run(frames, cfg: Dict, device: str = "cuda",
        async_loop_closing: Optional[bool] = None, warmup_scans: int = 30,
        **run_kw):
    """Build the pipeline on ``device``, run ``run_online`` over the
    frames; returns (pipeline, edges, latency report)."""
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline)
    pipe = NeuralSpectralCodecPipeline(cfg, device=device)
    loader = TimedLoader(frames)
    t0 = time.perf_counter()
    edges = pipe.run_online(
        loader, loop_closure_interval=cfg["deployment"].get(
            "loop_closing_interval", 10),
        async_loop_closing=async_loop_closing, **run_kw)
    report = latency_report(loader, pipe, warmup_scans,
                            float(cfg["deployment"]["max_latency_ms"]))
    report["wall_s"] = time.perf_counter() - t0
    report["keyframes"] = len(pipe.selector.keyframes)
    report["loop_closures"] = len(edges)
    report["warmup_s"] = getattr(pipe, "warmup_seconds", None)
    return pipe, edges, report


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=400)
    p.add_argument("--n-points", type=int, default=16384)
    p.add_argument("--warmup-scans", type=int, default=30)
    p.add_argument("--async", dest="async_lc", action="store_true",
                   help="verification on the background worker")
    p.add_argument("--no-fused-query", action="store_true",
                   help="the split encode → insert → query chain instead "
                        "of the one-dispatch serving step")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    from neural_spectral_codec_torch.data.synthetic import SyntheticLoader
    cfg = inference_config(encoding={"max_points": args.n_points},
                           deployment={"fused_query":
                                       not args.no_fused_query})
    base = SyntheticLoader(n_frames=args.frames, seed=3,
                           n_points=args.n_points, loops=2.5)
    frames = [base[i] for i in range(len(base))]
    _, _, out = run(frames, cfg, args.device, async_loop_closing=args.async_lc,
                    warmup_scans=args.warmup_scans)
    if args.device.startswith("cuda"):
        import torch
        from neural_spectral_codec_torch.utils.timing import gpu_label
        out["gpu"] = gpu_label()
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps(out, indent=2))
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
