"""One pass over the multi-device layer at tiny shapes: the counterpart of
``__graft_entry__.dryrun_multichip`` (JAX, :122-250).

    python -m neural_spectral_codec_torch.parallel.dryrun N [--device cuda]

Over an ``N``-device mesh (``create_mesh(N, device)``, or an explicit
``devices`` list, repeats allowed for logical shards): the batch-sharded
general and ring encoders (the ring one equal to the unsharded encoder),
one full-width node-sharded train step, the node-sharded eval forward
and the query-sharded recall (both equal to the single-device pass), and
the row-sharded W₁ query in float32 and uint16 storage and the L2 query
after a row refresh. Every check raises on failure.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike


def _example_graph(n_nodes: int, rng):
    from neural_spectral_codec_torch.keyframe.graph import build_graph
    poses = np.tile(np.eye(4, dtype=np.float32), (n_nodes, 1, 1))
    poses[:, 0, 3] = np.arange(n_nodes, dtype=np.float32) * 2.0
    feats = rng.random((n_nodes, 800), dtype=np.float32)
    return build_graph(feats, poses)


def _example_scans(n_scans: int, n_points: int, rng) -> np.ndarray:
    """Copied from ``__graft_entry__._example_scans``: NaN padding tails
    (scan 1), a sparse scan (scan 2), ranges under the gate (scan 3),
    dense full-view scans."""
    az = rng.uniform(-np.pi, np.pi, (n_scans, n_points))
    el = rng.uniform(np.deg2rad(-24.8), np.deg2rad(2.0), (n_scans, n_points))
    r = rng.uniform(2.0, 60.0, (n_scans, n_points))
    pts = np.stack([r * np.cos(el) * np.cos(az),
                    r * np.cos(el) * np.sin(az),
                    r * np.sin(el),
                    rng.uniform(0, 1, (n_scans, n_points))], axis=2)
    pts = pts.astype(np.float32)
    if n_scans >= 4 and n_points >= 64:
        pts[1, n_points // 2:] = np.nan
        pts[2, : n_points - 32] = np.nan
        pts[3, : n_points // 4, :3] *= 0.001
    return pts


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda",
                     devices: Optional[Sequence[DeviceLike]] = None) -> dict:
    """Run the pass; returns its loss, recall, query count and top-1."""
    from neural_spectral_codec_torch.keyframe.graph import graph_to_tensors
    from neural_spectral_codec_torch.models.gnn import (
        SpectralGNN, gnn_forward)
    from neural_spectral_codec_torch.ops.ring_path import (
        encode_points_ring_batch, make_structured_ring_scans)
    from neural_spectral_codec_torch.ops.spectral import SpectralEncoderConfig
    from neural_spectral_codec_torch.parallel import (
        Mesh, ShardedWassersteinRetriever, create_mesh, make_sharded_encoder,
        make_sharded_train_step)
    from neural_spectral_codec_torch.parallel.encode import (
        make_sharded_ring_encoder)
    from neural_spectral_codec_torch.parallel.train import (
        make_sharded_eval_step, place_graph)
    from neural_spectral_codec_torch.training.trainer import make_optimizer
    from neural_spectral_codec_torch.training.validation import (
        recall_loop_closure)

    mesh = (Mesh(devices) if devices is not None
            else create_mesh(n_devices, device))
    _check(mesh.size == n_devices, f"{mesh} is not {n_devices} wide")
    dev0 = mesh.devices[0]
    rng = np.random.default_rng(0)

    # -- batch-sharded encoding ------------------------------------------
    config = SpectralEncoderConfig(n_elevation=16, n_azimuth=90, n_bins=20)
    scans = torch.from_numpy(_example_scans(2 * n_devices, 1024, rng))
    descriptors = make_sharded_encoder(config, mesh)(scans, 2.0)
    _check(tuple(descriptors.shape) == (2 * n_devices, config.output_dim)
           and descriptors.device == dev0, "sharded encoder output")

    rows = tuple(range(16))
    ring_scans = torch.from_numpy(make_structured_ring_scans(
        2 * n_devices, 16, 128, config.projection, seed=0))
    ring_desc = make_sharded_ring_encoder(config, mesh, rows)(ring_scans, 2.0)
    want = encode_points_ring_batch(ring_scans.to(dev0), 2.0, config, rows)
    _check(torch.allclose(ring_desc, want, rtol=1e-6, atol=1e-7),
           "sharded ring path diverged")

    # -- full-width train step, node-sharded graph --------------------------
    n_nodes = 2 * n_devices
    graph = _example_graph(n_nodes, rng)
    model = SpectralGNN(generator=torch.Generator().manual_seed(0)).to(dev0)
    step = make_sharded_train_step(model, make_optimizer(model), mesh,
                                   shard_nodes=True)
    tri = torch.from_numpy(rng.integers(0, n_nodes, (2 * n_devices, 3)))
    gen = torch.Generator(device=dev0).manual_seed(1)
    loss = float(step(place_graph(graph, mesh, True), tri[:, 0], tri[:, 1],
                      tri[:, 2], torch.ones(len(tri), dtype=torch.bool),
                      0.1, gen))
    _check(np.isfinite(loss), f"non-finite training loss: {loss}")

    # -- node-sharded eval and query-sharded recall == one device ---------
    emb_sh = make_sharded_eval_step(model, mesh, shard_nodes=True)(
        place_graph(graph, mesh, True)).cpu().numpy()
    emb_1d = gnn_forward(model.eval(),
                         graph_to_tensors(graph, dev0)).cpu().numpy()
    _check(np.allclose(emb_sh, emb_1d, rtol=1e-5, atol=1e-6),
           "sharded eval forward diverged")
    period = n_nodes // 2
    poses = np.tile(np.eye(4, dtype=np.float32), (n_nodes, 1, 1))
    ang = np.arange(n_nodes) * 2 * np.pi / period
    poses[:, :3, 3] = np.stack([np.cos(ang), np.sin(ang),
                                np.zeros(n_nodes)], 1) * 20.0
    kw = dict(k=1, distance_threshold=1.0, skip_frames=period - 1)
    r_sh, nq_sh = recall_loop_closure(emb_sh, poses, mesh=mesh, **kw)
    r_1d, nq_1d = recall_loop_closure(emb_1d, poses, device=dev0, **kw)
    _check(nq_sh == nq_1d > 0 and abs(r_sh - r_1d) < 1e-6,
           f"recall {r_sh} over {nq_sh} vs {r_1d} over {nq_1d}")

    # -- row-sharded retrieval ------------------------------------------------
    hists = descriptors.cpu().numpy()
    positions = rng.random((hists.shape[0], 3)).astype(np.float32) * 500
    cap = 8 * n_devices
    db = ShardedWassersteinRetriever(mesh, n_bins=config.output_dim,
                                     capacity=cap)
    db.add_to_database(hists, positions)
    idx, dist = db.query(hists[1], top_k=3)
    _check(idx[0] == 1 and dist[0] < 1e-5, f"float32 top-1 {idx} {dist}")
    q_db = ShardedWassersteinRetriever(mesh, n_bins=config.output_dim,
                                       capacity=cap, storage="uint16")
    q_db.add_to_database(hists, positions)
    qidx, qdist = q_db.query(hists[1], top_k=3)
    _check(qidx[0] == 1 and qdist[0] < 1e-2, f"uint16 top-1 {qidx} {qdist}")
    emb_db = ShardedWassersteinRetriever(mesh, n_bins=config.output_dim,
                                         capacity=cap, metric="l2")
    emb_db.add_to_database(hists, positions)
    emb_db.update_rows(np.array([0, 1]), hists[:2][::-1])
    idx2, dist2 = emb_db.query(hists[0], top_k=1)
    _check(idx2[0] == 1 and dist2[0] < 1e-5, f"l2 top-1 {idx2} {dist2}")

    print(f"dryrun_multichip({n_devices}) OK on {mesh}: loss={loss:.4f}, "
          f"top1=({idx[0]}, {dist[0]:.2e}), ring encoder sharded "
          f"x{n_devices} equal, eval R@1={r_sh:.2f} over {nq_sh} queries "
          f"(sharded == one device)", flush=True)
    return {"loss": loss, "recall@1": r_sh, "n_queries": nq_sh,
            "top1": int(idx[0]), "top1_distance": float(dist[0])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
