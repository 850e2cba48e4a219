"""The online serving step as one static-shape executable: on a card, one
captured CUDA graph per shape, replayed for every keyframe.

PyTorch form of ``neural_spectral_codec_tpu/models/gnn._jitted_serving_step``
(gnn.py:234-284) and ``_jitted_fused_encode_apply`` (gnn.py:211-232). The
step, in this order:

  1. encode the scan: the ring path for (R, P, 3|4) input with
     ``row_of_ring`` (K2 + K1 on a card), else the general path for
     (N, 3|4) (K3 + K1);
  2. write the descriptor into the center node's feature row;
  3. GNN eval forward over the graph;
  4. stage-1 query against ``eff_size = size − (context_window − 1)`` rows
     (before the insert, so the new row is never its own answer);
  5. insert the row (CDF of the descriptor under W₁, the center embedding
     under L2) with its position at ``insert_at``.

Without a retriever the step stops after 3 (the fused encode + local
refresh). ``ServingExecutable`` holds the step for one static shape: its
inputs (points, the bucket's features / neighbors / mask / edge features,
``center``, ``insert_at``, ``eff_size``, ``qp``, ``insert_pos``) live in
one device buffer and its outputs (``desc``, the bucket's ``emb``, ``idx``,
``dist``) in another, so the step reads and writes only static memory and
no Python value is read from a tensor inside it. A call stages the inputs
in one pinned host buffer, moves them with one copy, runs the step, and
fetches the outputs with one copy into a second pinned buffer, as JAX runs
one program and one ``device_get`` (``LocalUpdateGNN``); ``serve_step``
returns the outputs on the device instead, as it always has.

On a card the first call of a shape runs the step once on the capture
stream (which fills the kernels' cached tables and scratch for that
stream), captures it into a ``torch.cuda.CUDAGraph`` in the memory pool
all serving graphs share (their temporaries never outlive a replay), and
replays it from then on. The hand-written kernels launch on the current
stream, which is the capture stream during the capture; the graph records
which of them it holds and credits their launch counts on every replay.
Capture reads the nodes back (``_build.graph_census``) and raises unless
the projection kernel's node kept its cooperative attribute (its grid
barrier needs every CTA resident). A failed capture or replay raises:
there is no fallback to the eager step. ``use_graph=False`` runs the same
step eagerly on the card, for comparisons; a CPU tensor always runs it
eagerly (the CPU tests' path).

Executables are cached as JAX caches its programs (``executable``): by
shape, path form, query/insert flags, ``top_k``, metric, storage, ε, the
model's identity and the database buffers' addresses, so a replaced
buffer (``clear_database``, a resume) gets a new capture and its old
entries are dropped.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.keyframe.graph import KeyframeGraph
from neural_spectral_codec_torch.models.gnn import SpectralGNN
from neural_spectral_codec_torch.ops.ring_path import encode_points_ring_batch
from neural_spectral_codec_torch.ops.spectral import (
    Alpha, SpectralEncoderConfig, encode_points_batch)
from neural_spectral_codec_torch.retrieval.retriever import (
    WassersteinRetriever)
from neural_spectral_codec_torch.utils.graph_exec import (
    Arena, ExecutableCache, SharedPool, capture_graph, replay)


def encode_scan(points: torch.Tensor, alpha: Alpha,
                config: SpectralEncoderConfig,
                row_of_ring: Optional[Sequence[int]] = None,
                n_folds: int = 2) -> torch.Tensor:
    """One scan → its (output_dim,) descriptor: ring path for a
    (R, P, 3|4) scan with ``row_of_ring``, general path for (N, 3|4)."""
    if points.dim() == 3:
        if row_of_ring is None:
            raise ValueError("a ring-structured (R, P, C) scan needs "
                             "row_of_ring")
        return encode_points_ring_batch(points[None], alpha, config,
                                        row_of_ring, n_folds)[0]
    return encode_points_batch(points[None], alpha, config)[0]


class StepShape(NamedTuple):
    """What a serving executable is specialised on besides identities."""

    points: Tuple[int, ...]              # (N, C) or (R, P, C)
    n_nodes: int                         # the bucket: padded node count
    degree: int                          # neighbor slots
    edge_dim: int
    row_of_ring: Optional[Tuple[int, ...]]
    n_folds: int
    config: SpectralEncoderConfig
    alpha: float
    top_k: int
    do_query: bool
    do_insert: bool


def _kernels() -> tuple:
    from neural_spectral_codec_torch.ops import (
        projection_kernel, ring_kernel, spectral_kernel)
    from neural_spectral_codec_torch.retrieval import query_kernel
    return (projection_kernel.KERNEL, ring_kernel.KERNEL,
            spectral_kernel.KERNEL, query_kernel.KERNEL,
            query_kernel.DIST_KERNEL, query_kernel.GROUP)


POOL = SharedPool()     # every serving graph of a device: one memory pool
# builds: executables ``executable`` made
STATS = {"captures": 0, "replays": 0, "eager_steps": 0, "builds": 0}


class ServingExecutable:
    """The serving step at one ``StepShape`` for one model and (optionally)
    one retriever: static input and output arenas, the step, and on a card
    with ``use_graph`` its captured CUDA graph.

    ``stage`` writes one step's inputs, ``execute`` runs it and returns
    numpy views of the outputs in the pinned host arena (valid until the
    next ``execute``)."""

    def __init__(self, model: SpectralGNN,
                 retriever: Optional[WassersteinRetriever], shape: StepShape,
                 device: torch.device, use_graph: bool = True):
        self.shape = shape
        self.device = device
        self.use_graph = use_graph and device.type == "cuda"
        self._model = weakref.ref(model)
        self._retriever = None if retriever is None else weakref.ref(retriever)
        n, deg = shape.n_nodes, shape.degree
        f32, i64 = torch.float32, torch.int64
        self.inputs = Arena([
            ("points", shape.points, f32),
            ("features", (n, model.input_dim), f32),
            ("neighbors", (n, deg), i64),
            ("mask", (n, deg), torch.bool),
            ("edge_feats", (n, deg, shape.edge_dim), f32),
            ("scalars", (3,), i64),          # center, insert_at, eff_size
            ("qp", (4,), f32),
            ("insert_pos", (3,), f32)], device)
        outs = [("desc", (shape.config.output_dim,), f32),
                ("emb", (n, model.output_dim), f32)]
        if retriever is not None and shape.do_query:
            outs += [("idx", (shape.top_k,), i64),
                     ("dist", (shape.top_k,), f32)]
        self.outputs = Arena(outs, device)
        self._staged_rows = n
        self._point_rows = shape.points[0]   # rows of the last scan staged
        self._device_inputs: List[tuple] = []
        cuda = device.type == "cuda"
        self._done = torch.cuda.Event() if cuda else None
        # the upload's end: the pinned input buffer may be restaged after it
        self._uploaded = torch.cuda.Event() if cuda else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.credits: Dict[object, int] = {}
        self.census: Optional[dict] = None
        self.capture_s: Optional[float] = None

    # -- the step ------------------------------------------------------------
    def _step(self) -> None:
        """The body: reads the input arena and the database, writes the
        output arena and the database row ``insert_at``. Static shapes,
        no host sync, no Python value from a tensor."""
        s, i, o = self.shape, self.inputs.dev, self.outputs.dev
        model = self._model()
        ret = None if self._retriever is None else self._retriever()
        center = i["scalars"][0:1]
        with torch.no_grad():
            desc = encode_scan(i["points"], s.alpha, s.config, s.row_of_ring,
                               s.n_folds)
            i["features"].index_copy_(0, center, desc[None])
            emb = model(i["features"], i["neighbors"], i["mask"],
                        i["edge_feats"])
            o["desc"].copy_(desc)
            o["emb"].copy_(emb)
            if ret is None:
                return
            vec = (emb.index_select(0, center) if ret.metric == "l2"
                   else desc[None])
            if s.do_query:
                idx, dist = ret.rank(vec, i["qp"][None], s.top_k,
                                     i["scalars"][2])
                o["idx"].copy_(idx[0])
                o["dist"].copy_(dist[0])
            if s.do_insert:
                ret.write_rows(i["scalars"][1], ret.encode_rows(vec),
                               i["insert_pos"][None])

    # -- inputs --------------------------------------------------------------
    def _put(self, name: str, value, rows: Optional[int] = None) -> None:
        """One input into its section: a tensor on the card is copied on
        the device after the upload, anything else into the host view."""
        if torch.is_tensor(value) and value.device.type != "cpu":
            if value.device != self.device:
                raise ValueError(f"input {name} on {value.device}, the step "
                                 f"runs on {self.device}")
            self._device_inputs.append((name, value, rows))
            return
        arr = value.numpy() if torch.is_tensor(value) else np.asarray(value)
        dst = self.inputs.np[name]
        if rows is None:
            if arr.shape != dst.shape:
                raise ValueError(f"input {name}: shape {arr.shape}, the "
                                 f"executable takes {dst.shape}")
            dst[...] = arr
        else:
            dst[:rows] = arr

    def _put_points(self, points) -> None:
        """The scan into its section. A host (N, 3|4) cloud of another
        size than a general-path executable's (max_points, 4) is padded
        into it as ``ops.range_image.pad_points`` pads (cut to max_points,
        intensity 0 for 3 channels, NaN rows after), without a padded copy
        first; rows left NaN by the last scan are not written again."""
        dst = self.inputs.np["points"]
        arr = (points.numpy() if torch.is_tensor(points)
               and points.device.type == "cpu" else points)
        if (not isinstance(arr, np.ndarray) or dst.ndim != 2
                or arr.shape == dst.shape):
            self._point_rows = dst.shape[0]
            self._put("points", points)
            return
        if arr.ndim != 2 or arr.shape[1] not in (3, 4):
            raise ValueError(f"points: shape {arr.shape}, the executable "
                             f"takes (N, 3|4) padded to {dst.shape}")
        n = min(len(arr), dst.shape[0])
        dst[:n, :arr.shape[1]] = arr[:n]
        if arr.shape[1] == 3:
            dst[:n, 3] = 0.0
        dst[n:max(self._point_rows, n)] = np.nan
        self._point_rows = n

    def stage(self, points, graph: KeyframeGraph, center: int,
              insert_at: int = 0, eff_size: int = 0, qp=None,
              insert_pos=None) -> None:
        """Write one step's inputs: ``points`` the scan (a host cloud of any
        size is padded into a general-path executable, ``_put_points``);
        ``graph`` (numpy or tensors) of at most ``n_nodes`` nodes fills the
        bucket's first rows and the rest is padding (isolated nodes, as
        ``keyframe.graph.pad_graph`` pads); ``qp`` defaults to zeros (no
        filter) and ``insert_pos`` to ``qp[:3]``. Waits for the last
        upload first: the pinned buffer is the one it read."""
        if self._uploaded is not None:
            self._uploaded.synchronize()
        n = graph.features.shape[0]
        if n > self.shape.n_nodes:
            raise ValueError(f"graph of {n} nodes in a bucket of "
                             f"{self.shape.n_nodes}")
        if not 0 <= center < n:
            raise ValueError(f"center {center} outside the graph of {n}")
        self._device_inputs = []
        self._put_points(points)
        for name in ("features", "neighbors", "mask", "edge_feats"):
            self._put(name, getattr(graph, name), n)
        if n < self._staged_rows:            # the pad rows after a larger one
            for name in ("features", "neighbors", "mask", "edge_feats"):
                self.inputs.np[name][n:self._staged_rows] = 0
        self._staged_rows = n
        self.inputs.np["scalars"][:] = (center, insert_at, eff_size)
        if qp is None:
            self.inputs.np["qp"][:] = 0.0
        else:
            self._put("qp", qp)
        if insert_pos is not None:
            self._put("insert_pos", insert_pos)
        elif qp is None:
            self.inputs.np["insert_pos"][:] = 0.0
        elif torch.is_tensor(qp) and qp.device.type != "cpu":
            self._put("insert_pos", qp[:3])
        else:
            self.inputs.np["insert_pos"][:] = np.asarray(qp)[:3]

    def _upload(self) -> None:
        self.inputs.upload()
        if self._uploaded is not None:
            self._uploaded.record()
        for name, value, rows in self._device_inputs:
            dst = self.inputs.dev[name]
            if rows is None:
                dst.copy_(value.reshape(dst.shape))
            else:
                dst[:rows].copy_(value)
                dst[rows:].zero_()

    # -- running -------------------------------------------------------------
    def execute(self, fetch: bool = True) -> dict:
        """Run the staged step (capturing it first on a card's first call)
        and fetch the outputs; returns numpy views of the host arena.
        ``fetch`` False skips the fetch and returns the device arena's
        tensors, with the step only enqueued (valid until the next
        ``execute``)."""
        if self._model() is None:
            raise RuntimeError("the executable's model no longer exists")
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            self._upload()
            if self.use_graph and self.graph is None:
                self._capture()
            if self.graph is not None:
                replay(self.graph, self.credits, STATS)
            else:
                self._step()
                STATS["eager_steps"] += 1
            if not fetch:
                return self.outputs.dev
            self.outputs.download()
            if self._done is not None:
                # the answer's one fetch: the host waits for the copy
                self._done.record()
                self._done.synchronize()
        return self.outputs.np

    def _capture(self) -> None:
        """Run the step once on the capture stream, then capture it."""
        pool = POOL.handle(self.device)
        graph, credits, self.capture_s = capture_graph(
            self._step, POOL.stream(self.device), pool, _kernels(),
            track=lambda g: POOL.track(self.device, pool, g))
        from neural_spectral_codec_torch import _build
        census = _build.graph_census(graph.raw_cuda_graph())
        if census["project_cooperative"] != census["project"]:
            raise RuntimeError(
                f"the projection kernel was captured without its cooperative "
                f"launch attribute ({census}); its grid barrier could "
                "deadlock in a replay")
        self.census, self.credits, self.graph = census, credits, graph
        STATS["captures"] += 1


_CACHE = ExecutableCache(STATS)


def executable(model: SpectralGNN, retriever: Optional[WassersteinRetriever],
               shape: StepShape, device: torch.device,
               use_graph: bool = True) -> ServingExecutable:
    """The cached executable of (shape, model, retriever's buffers); a new
    one is made (and on a card captured at its first ``execute``) on a
    miss. Entries of a retriever whose buffers were replaced, or of a
    model or retriever that no longer exists, are dropped on a miss."""
    if model.training:
        raise ValueError("the serving step runs the eval forward; call "
                         "model.eval() first")
    bufs = () if retriever is None else retriever.buffer_key()
    key = (str(device), shape, id(model), bufs,
           use_graph and device.type == "cuda")
    return _CACHE.get(
        key, lambda: ServingExecutable(model, retriever, shape, device,
                                       use_graph),
        (model,) if retriever is None else (model, retriever),
        None if retriever is None else (retriever, bufs))


def cached_executables() -> List[ServingExecutable]:
    """The executables in the cache, oldest first."""
    return _CACHE.values()


def clear_cache() -> None:
    """Drop every cached executable (and with them their graphs)."""
    _CACHE.clear()


def step_shape(points_shape, graph_nodes: int, degree: int, edge_dim: int,
               config: SpectralEncoderConfig, alpha: Alpha,
               row_of_ring: Optional[Sequence[int]] = None,
               n_folds: int = 2, top_k: int = 0, do_query: bool = False,
               do_insert: bool = False) -> StepShape:
    points_shape = tuple(int(v) for v in points_shape)
    if len(points_shape) == 3 and row_of_ring is None:
        raise ValueError("a ring-structured (R, P, C) scan needs row_of_ring")
    return StepShape(points_shape, int(graph_nodes), int(degree),
                     int(edge_dim),
                     None if len(points_shape) == 2 or row_of_ring is None
                     else tuple(int(r) for r in row_of_ring), int(n_folds),
                     config, float(alpha), int(top_k), bool(do_query),
                     bool(do_insert))


def scratch_execute(exe: ServingExecutable,
                    retriever: WassersteinRetriever, stage) -> None:
    """One scratch execution of a serving executable (on a card the
        first one captures it) that leaves the database as it was (JAX
        pipeline.py ``_warm_serve``): ``stage(insert_at, eff_size)`` stages
    the step at the next free row, which the step writes without claiming
    it (``fused_dispatch(insert=False)``), and the row's bytes are put back
    after it; at a full database there is no free row and
    ``fused_dispatch`` refuses."""

    def dispatch(insert_at: int, eff: int):
        row = slice(insert_at, insert_at + 1)
        kept = (retriever._db_rows[row].clone(),
                retriever._db_pos[row].clone())
        stage(insert_at, eff)
        exe.execute()
        retriever.write_rows(insert_at, *kept)

    retriever.fused_dispatch(dispatch, insert=False)


def _serving_executable(retriever, model, points, alpha, graph, top_k,
                        do_query, do_insert, config, row_of_ring, n_folds,
                        use_graph) -> ServingExecutable:
    if model.training:
        raise ValueError("serve_step runs the eval forward; call "
                         "model.eval() first")
    shape = step_shape(points.shape, graph.features.shape[0],
                       graph.neighbors.shape[1], graph.edge_feats.shape[2],
                       config, alpha, row_of_ring, n_folds,
                       int(min(top_k, retriever.capacity)), do_query,
                       do_insert)
    return executable(model, retriever, shape, retriever.device, use_graph)


def warm_serve_step(retriever: WassersteinRetriever, model: SpectralGNN,
                    points, alpha: Alpha, graph: KeyframeGraph, center: int,
                    top_k: int, do_query: bool = True, *,
                    config: SpectralEncoderConfig = SpectralEncoderConfig(),
                    row_of_ring: Optional[Sequence[int]] = None,
                    n_folds: int = 2, use_graph: bool = True) -> None:
    """Build (on a card: capture) the executable that ``serve_step`` with
    these arguments and ``do_insert`` runs, by a scratch execution that
    leaves the database and ``graph`` as they were."""
    exe = _serving_executable(retriever, model, points, alpha, graph, top_k,
                              do_query, True, config, row_of_ring, n_folds,
                              use_graph)
    scratch_execute(exe, retriever, lambda insert_at, eff: exe.stage(
        points, graph, center, insert_at, eff))


def serve_step(retriever: WassersteinRetriever, model: SpectralGNN,
               points, alpha: Alpha, graph: KeyframeGraph,
               center: int, qp, top_k: int,
               do_query: bool = True, do_insert: bool = True, *,
               config: SpectralEncoderConfig = SpectralEncoderConfig(),
               row_of_ring: Optional[Sequence[int]] = None,
               n_folds: int = 2, context_window: int = 1,
               insert_pos=None, use_graph: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run one serving step; returns ``(desc, emb, idx, dist)``, tensors on
    the retriever's device (copies of the output buffer; nothing is
    fetched, as the JAX step returns device arrays).

    ``graph`` holds the padded graph, numpy or tensors (on the host or the
    retriever's device); its shape is the executable's bucket. ``points``
    (numpy or a tensor) is one (N, 3|4) scan or, with ``row_of_ring``, one
    (R, P, 3|4) ring-structured scan. ``qp`` is the (4,) query filter
    [x, y, z, min_d] (min_d ≤ 0 turns the spatial filter off);
    ``insert_pos`` defaults to qp[:3]. ``idx``/``dist`` are the raw (k,)
    top-k (masked slots carry +inf), or None when ``do_query`` is off.
    ``model`` must be in eval mode. The center's feature row of a tensor
    graph is written in place with the descriptor, as the JAX serving
    loop writes it back after the step. ``use_graph`` False runs the step
    eagerly on a card (a CPU retriever always does)."""
    exe = _serving_executable(retriever, model, points, alpha, graph, top_k,
                              do_query, do_insert, config, row_of_ring,
                              n_folds, use_graph)

    def dispatch(insert_at: int, eff: int):
        exe.stage(points, graph, center, insert_at, eff, qp, insert_pos)
        return {name: v.clone()
                for name, v in exe.execute(fetch=False).items()}

    out = retriever.fused_dispatch(
        dispatch, insert=do_insert, writes_row=do_insert,
        exclude_last=context_window - 1 if do_query else 0)
    if torch.is_tensor(graph.features):
        graph.features[center].copy_(out["desc"])
    return (out["desc"], out["emb"], out.get("idx"), out.get("dist"))
