"""The port's flagship forward step as one function and its example
arguments: the counterpart of ``__graft_entry__.entry()`` (JAX,
``__graft_entry__.py:48-80``).

    fn, args = entry()            # device="cuda" unless the caller asks
    descriptors, embeddings = fn(*args)

``fn(points, alpha, model, neighbors, mask, edge_feats)`` turns B padded
scans (B, N, 3|4) into B spectral descriptors (``encode_points_batch``:
the projection kernel, then the spectral kernel on a card) and runs the
``SpectralGNN`` in eval mode over a keyframe graph whose B nodes are the
scans: (descriptors (B, 800), embeddings (B, 800)). The example is JAX's:
8 nodes of 16,384 points (``parallel.dryrun._example_scans``: a NaN tail,
a sparse scan, ranges under the gate, dense scans) on a temporal chain
(``_example_graph``), the numpy generator drawn in JAX's order, and the
full-width GNN (800 → 256 → 800) with seeded random weights.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device

N_NODES, N_POINTS = 8, 16384


def forward_step(points: torch.Tensor, alpha, model, neighbors: torch.Tensor,
                 mask: torch.Tensor, edge_feats: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scans → (descriptors, eval-mode GNN embeddings)."""
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_points_batch)
    descriptors = encode_points_batch(points, alpha, SpectralEncoderConfig())
    with torch.no_grad():
        embeddings = model(descriptors, neighbors, mask, edge_feats)
    return descriptors, embeddings


def entry(device: DeviceLike = "cuda") -> Tuple[Callable, tuple]:
    """(fn, example_args) on ``device``; the GNN's weights are drawn
    from seed 0, as JAX draws them from ``jax.random.key(0)``."""
    from neural_spectral_codec_torch.models.gnn import SpectralGNN
    from neural_spectral_codec_torch.parallel.dryrun import (
        _example_graph, _example_scans)

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    graph = _example_graph(N_NODES, rng)
    scans = _example_scans(N_NODES, N_POINTS, rng)
    model = SpectralGNN(generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    example_args = (
        torch.from_numpy(scans).to(dev),
        torch.tensor(2.0, dtype=torch.float32, device=dev),
        model,
        torch.tensor(graph.neighbors, dtype=torch.int64, device=dev),
        torch.tensor(graph.mask, dtype=torch.bool, device=dev),
        torch.tensor(graph.edge_feats, dtype=torch.float32, device=dev),
    )
    return forward_step, example_args
