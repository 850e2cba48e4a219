"""The stage-1 query's cost inside the graphs that run it, for this tree's
package or another checkout's, so that two commits can be compared on one
card in turns.

    python3 neural_spectral_codec_torch/experiments/serve_query_turns.py \\
        [--root DIR] [--json out.json]

``--root`` puts another checkout's root first on ``sys.path`` (a parent
commit unpacked with ``git archive`` into a gitignored directory), so
that its ``neural_spectral_codec_torch`` is the one built and measured;
the script calls only entry points both have. At ``chip_smoke.py`` phase
4's size (100,032 float32 rows of 800 bins: random histograms and
positions; the full-width SpectralGNN with random weights over a
1,000-node keyframe graph; one general-path scan of 133,632 points):
the device ms of one serving replay (CUDA events over 50 replays of the
captured step, query on, insert off) and the serving pool's MiB; then
the query graphs at Q = 1 and 32 (k = 10, spatial filter on) over
float32 and uint16 rows: device ms a call (every device operation it
enqueues, ``torch.profiler``) and the query pool's MiB. Prints one JSON
line (and writes it to ``--json``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

N_ROWS = 100_032
N_NODES = 1000
N_POINTS = 133_632
TOP_K = 10
MIN_DIST = 10.0
REPLAYS = 50


def _scan(rng):
    """A general-path scan: ranges 3-60 m over the sensor's elevations."""
    import numpy as np
    az = rng.uniform(-np.pi, np.pi, N_POINTS)
    el = np.deg2rad(rng.uniform(-24.8, 2.0, N_POINTS))
    r = rng.uniform(3.0, 60.0, N_POINTS)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el), rng.random(N_POINTS)],
                    axis=1).astype(np.float32)


def measure() -> dict:
    import numpy as np
    import torch
    from neural_spectral_codec_torch import _build
    from neural_spectral_codec_torch.keyframe.graph import (
        build_graph, graph_to_tensors)
    from neural_spectral_codec_torch.models import SpectralGNN, serve_step
    from neural_spectral_codec_torch.models import serving
    from neural_spectral_codec_torch.ops.spectral import SpectralEncoderConfig
    from neural_spectral_codec_torch.retrieval import retriever as R
    from neural_spectral_codec_torch.utils.timing import device_ops, gpu_label
    if not torch.cuda.is_available():
        raise SystemExit("serve_query_turns: needs a CUDA card")
    _build.build()
    dev = torch.device("cuda")
    cfg = SpectralEncoderConfig()
    bins = cfg.output_dim
    g = torch.Generator(device=dev).manual_seed(7)
    ret = R.WassersteinRetriever(n_bins=bins, capacity=N_ROWS + 8, device=dev)
    for lo in range(0, N_ROWS, 10_000):
        c = min(10_000, N_ROWS - lo)
        h = torch.rand((c, bins), generator=g, device=dev) ** 4
        pos = (torch.rand((c, 3), generator=g, device=dev) - 0.5) * 20_000.0
        ret.add_to_database(h, pos)
    rng = np.random.default_rng(7)
    desc0 = rng.random((N_NODES, bins)).astype(np.float32) ** 4
    desc0 /= desc0.sum(axis=1, keepdims=True)
    poses = np.tile(np.eye(4), (N_NODES, 1, 1))
    poses[:, 0, 3] = np.arange(N_NODES) * 2.0
    graph = graph_to_tensors(build_graph(
        desc0, poses, loop_closures=[(i, i + 500) for i in range(0, 500, 25)]),
        dev)
    model = SpectralGNN(generator=torch.Generator().manual_seed(7)).to(
        dev).eval()
    points = _scan(rng)
    qp = np.array([poses[100, 0, 3], 0.0, 0.0, MIN_DIST], np.float32)
    for _ in range(3):
        serve_step(ret, model, points, cfg.alpha, graph, 100, qp, TOP_K,
                   do_query=True, do_insert=False, config=cfg)
    torch.cuda.synchronize()
    (exe,) = [e for e in serving.cached_executables() if e.graph is not None]
    exe.graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPLAYS):
        exe.graph.replay()
    end.record()
    end.synchronize()
    out = {"gpu": gpu_label(), "root": str(Path(_build.__file__).parents[1]),
           "serve_replay_ms": start.elapsed_time(end) / REPLAYS,
           "serve_pool_mib": serving.POOL.bytes(dev) / 2 ** 20}
    serving.clear_cache()

    u16 = R.WassersteinRetriever(n_bins=bins, capacity=ret.capacity,
                                 storage="uint16", device=dev)
    size = ret.database_size
    u16.write_rows(0, R.quantize_cdf(ret._db_rows[:size]), ret._db_pos[:size])
    u16.database_size = size
    qs = (torch.rand((32, bins), generator=g, device=dev) ** 4).cpu().numpy()
    qpos = ret._db_pos[:32].cpu().numpy() + 1.0
    for name, r in (("float32", ret), ("uint16", u16)):
        def one(r=r):
            return r.query(qs[3], TOP_K, query_position=qpos[3],
                           spatial_min_distance=MIN_DIST)

        def batch(r=r):
            return r.query_batch(qs, TOP_K, query_positions=qpos,
                                 spatial_min_distance=MIN_DIST)

        for fn, q, calls in ((one, 1, 5), (batch, 32, 2)):
            fn()
            ops = device_ops(fn, calls=calls)
            out[f"query_{name}_q{q}_device_ms"] = (
                sum(us for _, us in ops) / calls / 1e3)
    out["query_pool_mib"] = R.POOL.bytes(dev) / 2 ** 20
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="another checkout's root to measure")
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()
    root = Path(args.root).resolve() if args.root else \
        Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    out = measure()
    print(json.dumps(out), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(out) + "\n")


if __name__ == "__main__":
    main()
