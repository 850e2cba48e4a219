"""Where the multi-device layer's time goes on one card: wall time
against device time, on four logical shards by default.

    python -m neural_spectral_codec_torch.experiments.parallel_profile \\
        [--nodes 20000] [--shards 4] [--rows 100000] [--json out.json]

For a 4096-triplet train step of the full-width SpectralGNN on a
``--nodes`` graph (``scale_100k.synthetic_city``) single-device and bf16
(``train_step``, op by op), DP and node-sharded over ``Mesh([cuda:0] *
shards)`` (``ShardedTrainStepExecutable``, a captured graph), and for one
W₁ query against ``--rows`` × 800 rows, unsharded and row-sharded (each
through its query graph): the host
clock per call (5 calls after one warm-up, synchronised) and, from
``torch.profiler`` over 3 calls, the device time and the number of device
operations per call, and their ratio, the device's busy share. Then the
device time of ``retriever.smallest_k`` (int64 keys, ``lax.top_k``'s tie
order) against ``torch.topk`` for the 10 smallest of (1, n) and (32, n)
rows, queued bare calls. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def _profile(fn, calls: int = 3) -> dict:
    from neural_spectral_codec_torch.utils.timing import device_ops
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / 5
    ops = device_ops(fn, calls)
    device = sum(us for _, us in ops) / calls / 1e3
    return {"wall_ms": wall, "device_ms": device, "ops": len(ops) / calls,
            "busy_share": device / wall}


def run(nodes: int = 20_000, shards: int = 4, rows: int = 100_000,
        log=print) -> dict:
    from neural_spectral_codec_torch import resolve_device
    from neural_spectral_codec_torch.experiments.scale_100k import (
        synthetic_city)
    from neural_spectral_codec_torch.keyframe.graph import (
        build_graph, graph_to_tensors)
    from neural_spectral_codec_torch.models import SpectralGNN
    from neural_spectral_codec_torch.parallel import (
        Mesh, ShardedWassersteinRetriever)
    from neural_spectral_codec_torch.parallel.train import (
        ShardedTrainStepExecutable)
    from neural_spectral_codec_torch.retrieval import WassersteinRetriever
    from neural_spectral_codec_torch.retrieval.retriever import smallest_k
    from neural_spectral_codec_torch.training.trainer import (
        make_optimizer, train_step)
    from neural_spectral_codec_torch.utils.timing import (
        gpu_label, time_queued_ms)

    dev = resolve_device("cuda")
    mesh = Mesh([dev] * shards)
    out = {"gpu": gpu_label(), "nodes": nodes, "shards": shards,
           "rows": rows}
    log(out["gpu"])
    desc, poses, _ = synthetic_city(nodes)
    graph = build_graph(desc, poses, temporal_neighbors=5)
    tri = torch.from_numpy(np.random.default_rng(0).integers(
        0, nodes, (4096, 3))).to(dev)
    mask = torch.ones(4096, dtype=torch.bool, device=dev)
    g1 = graph_to_tensors(graph, dev)
    for mode, dtype in (("single", None), ("bf16", torch.bfloat16),
                        ("dp", None), ("nodes", None)):
        model = SpectralGNN(compute_dtype=dtype,
                            generator=torch.Generator().manual_seed(0))
        model.to(dev)
        opt = make_optimizer(model)
        gen = torch.Generator(device=dev).manual_seed(1)
        if mode in ("single", "bf16"):
            def fn():
                return train_step(model, opt, g1, tri[:, 0], tri[:, 1],
                                  tri[:, 2], mask, 0.1, generator=gen)
        else:
            exe = ShardedTrainStepExecutable(
                model, opt, mesh, mode == "nodes", nodes, graph.max_degree,
                graph.edge_feats.shape[2], len(tri), 0.1, 1.0, False, gen)
            exe.load_graph(graph)

            def fn():
                return exe.run({"triplets": tri, "tmask": mask},
                               fetch=False)[0]["loss"]
        out[f"train_{mode}"] = _profile(fn)
        log(f"train_{mode}: {json.dumps(out[f'train_{mode}'])}")

    db = torch.rand((rows, 800), device=dev) ** 4
    pos = (torch.rand((rows, 3), device=dev) - 0.5) * 20_000.0
    q = db[17].cpu().numpy()
    qpos = pos[17].cpu().numpy() + 50.0
    for name, ret in (("query_unsharded", WassersteinRetriever(
            n_bins=800, capacity=rows, device=dev)),
            ("query_sharded", ShardedWassersteinRetriever(
                mesh, n_bins=800, capacity=rows))):
        ret.add_to_database(db, pos)
        out[name] = _profile(lambda: ret.query(
            q, top_k=10, query_position=qpos, spatial_min_distance=10.0),
            calls=5)
        log(f"{name}: {json.dumps(out[name])}")
        del ret
    for n in (rows // shards, rows):
        for n_q in (1, 32):
            d = torch.rand((n_q, n), device=dev)
            key = f"top10_of_{n_q}x{n}"
            out[key] = {
                "smallest_k_us": 1e3 * time_queued_ms(
                    lambda: smallest_k(d, 10)),
                "torch_topk_us": 1e3 * time_queued_ms(
                    lambda: torch.topk(d, 10, dim=1, largest=False))}
            log(f"{key}: {json.dumps(out[key])}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = run(args.nodes, args.shards, args.rows)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
