"""Training at the reference's scale on one device: a keyframe graph of
100,000 nodes (``experiments/scale_100k.py`` of the JAX package).

    python -m neural_spectral_codec_torch.experiments.scale_100k \\
        --nodes 100000 --device cuda [--steps S] [--json out.json]
        [--compare-sharded [--shards 4]]

Times, on the host clock with the device synchronised: the graph build,
hard-negative mining over all anchors, one epoch of 4096-triplet steps on
the full-width SpectralGNN (800 → 256 → 800, 3 GAT layers, dropout 0.1)
after one warm-up step, the eval embedding and Recall@{1,5,10} over all
revisit queries (``training.validation.recall_loop_closure``; the JAX
script ranks with ``evaluation.evaluate_place_recognition``). On a CUDA
device it reads peak memory from ``torch.cuda.max_memory_allocated``.
``--compare-sharded`` times the single-device step against the
node-sharded one instead (``compare_sharded``).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def synthetic_city(n_nodes: int, dim: int = 800, seed: int = 0,
                   revisit_period: int = 2000):
    """Trajectory with a loop every ``revisit_period`` frames (laps within
    ~2 m of each other) and descriptors that are a smooth place signature
    plus noise, normalised like spectral histograms. Copied from the JAX
    script (``experiments/scale_100k.py:39``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_nodes)
    theta = 2 * np.pi * (t % revisit_period) / revisit_period
    lap = t // revisit_period
    positions = np.stack([
        300 * np.cos(theta) + 0.5 * rng.standard_normal(n_nodes),
        300 * np.sin(theta) + 0.5 * rng.standard_normal(n_nodes),
        np.zeros(n_nodes)], axis=1).astype(np.float32)
    W = rng.standard_normal((3, dim)).astype(np.float32) * 0.05
    sig = np.abs(np.sin(positions @ W + rng.standard_normal(dim) * 0.0))
    sig = sig + 0.25 * rng.random((n_nodes, dim), dtype=np.float32)
    desc = (sig / sig.sum(axis=1, keepdims=True)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_nodes, 1, 1))
    poses[:, :3, 3] = positions
    return desc, poses, lap.astype(np.int64)


class _Fixed:
    """A miner that hands out triplets mined beforehand."""

    def __init__(self, triplets: np.ndarray):
        self.triplets = triplets

    def mine_triplets(self, **kw):
        return self.triplets


def run(nodes: int, steps=None, device="cuda", log=print) -> dict:
    """The measurement; returns its numbers (seconds, ms, GiB)."""
    with tempfile.TemporaryDirectory(prefix="scale_ckpt_") as ckpt:
        return _run(nodes, steps, device, ckpt, log)


def _run(nodes, steps, device, ckpt, log) -> dict:
    from neural_spectral_codec_torch.device import resolve_device
    from neural_spectral_codec_torch.keyframe.graph import build_graph
    from neural_spectral_codec_torch.models.gnn import SpectralGNN
    from neural_spectral_codec_torch.training.miner import (
        create_triplet_miner)
    from neural_spectral_codec_torch.training.trainer import GNNTrainer
    from neural_spectral_codec_torch.training.validation import (
        recall_loop_closure)

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.init()          # the peak-memory counters need a context
        torch.cuda.reset_peak_memory_stats(dev)
    desc, poses, _ = synthetic_city(nodes)
    out = {"nodes": nodes, "device": str(dev)}

    t0 = time.perf_counter()
    g = build_graph(desc, poses, temporal_neighbors=5)
    out["graph_build_s"] = time.perf_counter() - t0

    miner = create_triplet_miner(positive_distance_max=5.0,
                                 negative_distance_min=10.0,
                                 negative_distance_max=100.0, device=dev)
    t0 = time.perf_counter()
    triplets = miner.mine_triplets(desc, poses)
    out["mining_s"] = time.perf_counter() - t0
    out["n_triplets"] = int(len(triplets))
    log(f"scale: {nodes} nodes on {dev}; graph build "
        f"{out['graph_build_s']:.3f} s; mining {len(triplets)} triplets "
        f"over all anchors {out['mining_s']:.3f} s")

    B = 4096
    if steps:
        triplets = triplets[:steps * B]
    trainer = GNNTrainer(model=SpectralGNN(), checkpoint_dir=ckpt,
                         triplets_per_step=B, seed=0, device=dev)
    t0 = time.perf_counter()
    trainer.train_epoch(g, _Fixed(triplets[:B]), poses, desc)   # warm-up
    sync()
    out["warmup_step_s"] = time.perf_counter() - t0
    trainer.epoch = 1
    t0 = time.perf_counter()
    loss = trainer.train_epoch(g, _Fixed(triplets), poses, desc)
    sync()
    out["epoch_s"] = time.perf_counter() - t0
    out["epoch_steps"] = -(-len(triplets) // B)
    out["ms_per_step"] = 1e3 * out["epoch_s"] / out["epoch_steps"]
    out["avg_loss"] = float(loss)
    log(f"scale: epoch of {out['epoch_steps']} steps x {B} triplets "
        f"{out['epoch_s']:.3f} s = {out['ms_per_step']:.3f} ms/step "
        f"(warm-up step {out['warmup_step_s']:.3f} s), avg loss "
        f"{out['avg_loss']:.5f}")

    t0 = time.perf_counter()
    emb = trainer.embed(g)
    out["embed_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in (1, 5, 10):
        r, nq = recall_loop_closure(emb, poses, k, device=dev)
        out[f"recall@{k}"] = r
    out["n_queries"] = nq
    out["validation_s"] = time.perf_counter() - t0
    out["raw_recall@1"] = recall_loop_closure(desc, poses, 1, device=dev)[0]
    log(f"scale: embed {out['embed_s']:.3f} s; Recall@1/5/10 "
        f"{out['recall@1']:.4f}/{out['recall@5']:.4f}/"
        f"{out['recall@10']:.4f} over {nq} queries in "
        f"{out['validation_s']:.3f} s; raw descriptors R@1 "
        f"{out['raw_recall@1']:.4f}")
    if dev.type == "cuda":
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"scale: peak device memory {out['peak_memory_gib']:.3f} GiB "
            f"(torch.cuda.max_memory_allocated)")
    return out


def compare_sharded(nodes: int, steps=None, device="cuda", shards: int = 4,
                    log=print) -> dict:
    """The single-device trainer against the node-sharded one on
    ``shards`` logical shards of ``device`` (JAX ``--compare-sharded``,
    scale_100k.py:86-112), full-width SpectralGNN (dropout 0.1), the same
    seed: a first one-step epoch of 4096 random triplets, whose losses
    must agree (rtol 2e-5, atol 1e-6, the JAX script's bar; both start
    from the same state), then a timed epoch of ``steps`` × 4096 (1 by
    default) for ms per step. Later losses are reported, not held: Adam's
    first update moves each weight by about lr·sign(g), so gradients that
    differ in their rounding (a sum in another order, the card's atomics)
    send the two runs apart."""
    from neural_spectral_codec_torch.device import resolve_device
    from neural_spectral_codec_torch.keyframe.graph import build_graph
    from neural_spectral_codec_torch.models.gnn import SpectralGNN
    from neural_spectral_codec_torch.parallel import Mesh
    from neural_spectral_codec_torch.training.trainer import GNNTrainer

    dev = resolve_device(device)
    desc, poses, _ = synthetic_city(nodes,
                                    revisit_period=max(nodes // 4, 10))
    g = build_graph(desc, poses, temporal_neighbors=5)
    rng = np.random.default_rng(0)
    trip = np.stack([rng.integers(0, nodes, 4096 * (steps or 1))
                     for _ in range(3)], 1)
    out = {"nodes": nodes, "device": str(dev), "shards": shards,
           "steps": steps or 1}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for name, mesh in (("single", None), ("sharded", Mesh([dev] * shards))):
        with tempfile.TemporaryDirectory(prefix="scale_ckpt_") as ckpt:
            tr = GNNTrainer(model=SpectralGNN(), checkpoint_dir=ckpt,
                            triplets_per_step=4096, seed=0, device=dev,
                            mesh=mesh, shard_nodes=mesh is not None)
            first = tr.train_epoch(g, _Fixed(trip[:4096]), poses, desc)
            tr.epoch = 1
            sync()
            t0 = time.perf_counter()
            loss = tr.train_epoch(g, _Fixed(trip), poses, desc)
            sync()
            seconds = time.perf_counter() - t0
        out[f"{name}_first_loss"] = first
        out[f"{name}_epoch_loss"] = loss
        out[f"{name}_ms_per_step"] = 1e3 * seconds / out["steps"]
        log(f"compare-sharded: {name} ({shards if mesh else 1} shard(s) on "
            f"{dev}, {nodes} nodes): first step loss {first}, then "
            f"{out['steps']} step(s) avg loss {loss}, "
            f"{out[f'{name}_ms_per_step']:.3f} ms/step")
    np.testing.assert_allclose(out["sharded_first_loss"],
                               out["single_first_loss"], rtol=2e-5,
                               atol=1e-6)
    log("compare-sharded OK: node-sharded training matches the single "
        "device")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=None,
                    help="cap the epoch at this many steps")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare-sharded", action="store_true",
                    help="single-device against node-sharded training on "
                         "--shards logical shards of --device")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--json", default=None,
                    help="write the numbers to this JSON file")
    args = ap.parse_args(argv)
    if args.compare_sharded:
        out = compare_sharded(args.nodes, args.steps, args.device,
                              args.shards)
    else:
        out = run(args.nodes, args.steps, args.device)
    if args.device.startswith("cuda"):
        from neural_spectral_codec_torch.utils.timing import gpu_label
        out["gpu"] = gpu_label()
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
