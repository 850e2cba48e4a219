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

JAX jits the step; here ``fn`` (``forward_step``) runs one static step a
(shapes, model), ``ForwardExecutable``: the arguments are copied into a
static input arena on their device, the step runs (on a card: a CUDA
graph captured at the first call, holding K3's cooperative launch and
K1, and replayed after), and the outputs come back as copies, so a later
call never overwrites a caller's result. ``forward_eager`` is the same
step op by op.
"""

from __future__ import annotations

import weakref
from typing import Callable, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.utils.graph_exec import (
    Arena, ExecutableCache, GraphStep, SharedPool)

N_NODES, N_POINTS = 8, 16384
POOL = SharedPool()     # every entry() graph of a device: one memory pool
STATS = {"captures": 0, "replays": 0, "eager_steps": 0}
_CACHE = ExecutableCache()


def forward_eager(points: torch.Tensor, alpha, model,
                  neighbors: torch.Tensor, mask: torch.Tensor,
                  edge_feats: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scans → (descriptors, eval-mode GNN embeddings), op by op."""
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_points_batch)
    descriptors = encode_points_batch(points, alpha, SpectralEncoderConfig())
    with torch.no_grad():
        embeddings = model(descriptors, neighbors, mask, edge_feats)
    return descriptors, embeddings


class ForwardExecutable(GraphStep):
    """``forward_eager`` at one (points, graph) shape for one model
    (``utils/graph_exec.GraphStep``): points, α (a 0-d float32: the
    spectral kernel's bin ranges are computed from it inside the step),
    neighbors, mask and edge features in; descriptors and embeddings
    out. The model's parameters are read by address."""

    def __init__(self, model, points_shape: tuple, degree: int,
                 edge_dim: int, device: torch.device, use_graph: bool = True):
        super().__init__(device, use_graph, POOL, STATS)
        self._model = weakref.ref(model)
        b = points_shape[0]
        f32 = torch.float32
        self.inputs = Arena([
            ("points", points_shape, f32), ("alpha", (), f32),
            ("neighbors", (b, degree), torch.int64),
            ("mask", (b, degree), torch.bool),
            ("edge_feats", (b, degree, edge_dim), f32)], device)
        self.outputs = Arena([("descriptors", (b, model.input_dim), f32),
                              ("embeddings", (b, model.output_dim), f32)],
                             device)

    def _step(self) -> None:
        i, o = self.inputs.dev, self.outputs.dev
        desc, emb = forward_eager(i["points"], i["alpha"], self._model(),
                                  i["neighbors"], i["mask"], i["edge_feats"])
        o["descriptors"].copy_(desc)
        o["embeddings"].copy_(emb)

    def _kernels(self) -> tuple:
        from neural_spectral_codec_torch.ops import (
            projection_kernel, spectral_kernel)
        return projection_kernel.KERNEL, spectral_kernel.KERNEL

    def _check(self, graph) -> None:
        from neural_spectral_codec_torch import _build
        census = _build.graph_census(graph.raw_cuda_graph())
        if census["project"] != 1 or census["project_cooperative"] != 1 \
                or census["spectral"] != 1:
            raise RuntimeError(
                f"entry()'s graph must hold one cooperative projection "
                f"kernel and one spectral kernel ({census})")
        self.census = census


def forward_executable(points: torch.Tensor, model, neighbors: torch.Tensor,
                       edge_feats: torch.Tensor,
                       use_graph: bool = True) -> ForwardExecutable:
    """The cached step of (device, shapes, model), made on a miss."""
    if model.training:
        raise ValueError("entry()'s step runs the eval forward; call "
                         "model.eval() first")
    device = points.device
    graphed = use_graph and device.type == "cuda"
    shape = (tuple(points.shape), tuple(neighbors.shape),
             int(edge_feats.shape[-1]))
    return _CACHE.get(
        (str(device), shape, id(model), graphed),
        lambda: ForwardExecutable(model, shape[0], shape[1][1], shape[2],
                                  device, use_graph), (model,))


def forward_step(points: torch.Tensor, alpha, model, neighbors: torch.Tensor,
                 mask: torch.Tensor, edge_feats: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scans → (descriptors, eval-mode GNN embeddings) through the static
    step of these shapes (on a card a graph replay; the first call
    captures it), returned as copies on the points' device."""
    exe = forward_executable(points, model, neighbors, edge_feats)
    out, _ = exe.run({"points": points, "alpha": alpha,
                      "neighbors": neighbors, "mask": mask,
                      "edge_feats": edge_feats}, fetch=False)
    return out["descriptors"], out["embeddings"]


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
