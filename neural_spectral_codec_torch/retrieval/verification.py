"""Geometric verification of loop-closure candidates.

Port of ``neural_spectral_codec_tpu/retrieval/verification.py``. A
candidate is accepted iff registration reaches fitness ≥ 0.3 and inlier
RMSE ≤ 0.5 m (1.0 m correspondences, 30 iterations, 0.3 m voxels); the
information matrix is the fitness-scaled diagonal heuristic.

Two backends, chosen once at construction:

  * ``"native"``: the host C++ library (``native/geom.py``: grid-accelerated
    correspondences, ctypes releases the GIL so candidates verify in
    parallel threads). ``"auto"`` means this one, and raises when the
    library cannot be built: no quiet fallback.
  * ``"torch"`` (also named ``"jax"``, the JAX package's name for it, so
    that its configs build): the fixed-shape registration of the JAX
    package's ``"jax"`` backend on the verifier's device: padded point
    sets, all-pairs nearest neighbours, ``max_iterations`` Gauss-Newton
    steps (``icp_kernel``: point-to-point Kabsch, point-to-plane, or
    generalized ICP with k-NN disk-regularised covariances on both clouds).
    The work grows as P² per iteration (16.8 M distances at P = 4,096).

On a card the torch backend runs each of JAX's jitted programs as one
captured CUDA graph. ``prepare`` (JAX's ``_knn_covariances`` or
``_knn_normals`` a cloud) is a ``PrepareExecutable``: the host's voxel
grid and padding, one pinned upload, one replay of the k-NN search and
the PCA, and device copies that the ``PreparedCloud`` owns. A pair
(``_icp_kernel``, every mode) is a ``RegistrationExecutable``: the two
prepared clouds copied into its input arena on the device, one replay
and one fetch of 18 floats. Their kernels are hand-written and built
from ``csrc/`` at first use: the nearest neighbour of every moved source
point (kernel N, ``nearest_kernel``, 31 launches a replay), the whole
point-to-point update after it, weights, centroids, H and the Kabsch
solve (kernel R, ``pca_kernel``, one an iteration) and, in ``prepare``,
the k nearest neighbours within a cloud (kernel K, ``knn_kernel``) and
their PCA to normals or covariances
(kernel C, ``pca_kernel``). All of it runs on the verifier's own stream
(``verifier_stream``), apart from the current stream on which the
serving graphs replay. A CPU tensor runs the same steps eagerly with the
kernels' plain versions (the tests' path).

Matrix products here are float32 with TF32 off (``resolve_device``).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device
from neural_spectral_codec_torch.utils.graph_exec import (
    Arena, ExecutableCache, GraphStep, SharedPool, capture_graph, replay)

logger = logging.getLogger(__name__)

MODES = {"icp": "p2p", "point_to_plane": "p2l", "gicp": "gicp"}
# The modes whose registration step is captured into a CUDA graph on a
# card: all three, since point-to-point's Kabsch solve is kernel R and not
# torch.linalg.svd and det, which copy through the host
# (experiments/capture_probe.py)
GRAPH_MODES = ("p2p", "p2l", "gicp")
# what prepare computes for each method, and with what k (JAX's defaults:
# _knn_normals k = 16; GICP's k is the verifier's covariance_knn)
PREPARE_MODES = {"icp": None, "point_to_plane": "normals",
                 "gicp": "covariances"}
NORMALS_KNN = 16


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Mean of the finite points per voxel (host numpy; copied from JAX
    verification.py:36)."""
    pts = points[:, :3]
    ok = np.isfinite(pts).all(axis=1)
    pts = pts[ok]
    if len(pts) == 0 or voxel_size <= 0:
        return pts
    v = np.floor(pts / voxel_size).astype(np.int64)
    off = 1 << 20
    key = ((v[:, 0] + off) << 42) | ((v[:, 1] + off) << 21) | (v[:, 2] + off)
    order = np.argsort(key)
    key, pts = key[order], pts[order]
    uniq, start, counts = np.unique(key, return_index=True, return_counts=True)
    sums = np.add.reduceat(pts, start, axis=0)
    return (sums / counts[:, None]).astype(np.float32)


def _pad(points: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 3) zero-padded points and their validity mask; an oversized
    cloud is subsampled with an even stride (JAX verification.py:53)."""
    out = np.zeros((n, 3), np.float32)
    m = np.zeros(n, bool)
    k = min(len(points), n)
    if k:
        sel = (np.linspace(0, len(points) - 1, k).astype(int)
               if len(points) > n else np.arange(k))
        out[:k] = points[sel, :3]
        m[:k] = True
    return out, m


def knn_normals(pts: torch.Tensor, mask: torch.Tensor,
                k: int = NORMALS_KNN) -> torch.Tensor:
    """Unit normal per point: the eigenvector of the smallest eigenvalue
    of its k-NN covariance (kernels K and C on a card; the sign is
    arbitrary in the plain version, fixed by the kernel)."""
    from neural_spectral_codec_torch.retrieval.knn_kernel import knn
    from neural_spectral_codec_torch.retrieval.pca_kernel import knn_pca
    return knn_pca(pts, knn(pts, mask, k), "normals")


def knn_covariances(pts: torch.Tensor, mask: torch.Tensor, k: int = 20,
                    eps: float = 1e-3) -> torch.Tensor:
    """GICP covariances V diag(ε, 1, 1) Vᵀ from the k-NN PCA eigenvectors
    (ascending eigenvalues): the normal direction squashed to ε (kernels K
    and C on a card)."""
    from neural_spectral_codec_torch.retrieval.knn_kernel import knn
    from neural_spectral_codec_torch.retrieval.pca_kernel import knn_pca
    return knn_pca(pts, knn(pts, mask, k), "covariances", eps)


def _transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ T[:3, :3].T + T[:3, 3]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) update for Gauss-Newton, xi = [ω, t]: Rodrigues rotation of
    ω, translation t (JAX ``_se3_exp``)."""
    w, t = xi[:3], xi[3:]
    th = torch.linalg.vector_norm(w) + 1e-12
    z = torch.zeros((), dtype=xi.dtype, device=xi.device)
    K = torch.stack([torch.stack([z, -w[2], w[1]]),
                     torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + torch.sin(th) / th * K + (1 - torch.cos(th)) / (th * th) * (K @ K)
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.solve`` without its error check (a host sync)."""
    return torch.linalg.solve_ex(A, b, check_errors=False)[0]


def icp_kernel(src: torch.Tensor, src_mask: torch.Tensor, dst: torch.Tensor,
               dst_mask: torch.Tensor, normals: Optional[torch.Tensor],
               cov_src: Optional[torch.Tensor],
               cov_dst: Optional[torch.Tensor], init_T: torch.Tensor,
               max_iterations: int, mode: str, max_corr: float = 1.0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-shape registration (JAX ``_icp_kernel``,
    verification.py:117-193), mode ∈ {"p2p", "p2l", "gicp"}. Returns
    (T, fitness, inlier_rmse) as tensors on the inputs' device.

    Static shapes and no host sync (no ``.item()``, no Python value read
    from a tensor, no solver error check: ``inv_ex`` and ``solve_ex`` skip
    it with the same arithmetic, and point-to-point's update after the
    search is kernel R), so that a card captures all ``max_iterations``
    steps and the final correspondence search in one CUDA graph; the loop
    is unrolled into it."""
    from neural_spectral_codec_torch.retrieval.nearest_kernel import nearest
    from neural_spectral_codec_torch.retrieval.pca_kernel import p2p_update
    dev, f32 = src.device, torch.float32
    n_src = src_mask.sum().clamp(min=1).to(f32)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def correspondences(T):
        moved = _transform(T, src)
        j, d2 = nearest(moved, dst, dst_mask)          # kernel N on a card
        dist = torch.sqrt(d2)
        w = src_mask & (dist <= max_corr)
        return moved, j, dist, w.to(f32)

    def p2p_step(T):
        j, d2 = nearest(_transform(T, src), dst, dst_mask)   # kernel N
        # the weights, weighted Kabsch from the ORIGINAL source to the
        # matched targets and its solve: kernel R on a card
        return p2p_update(src, src_mask, dst, j, d2, max_corr)

    def p2l_step(T):
        moved, j, _, w = correspondences(T)
        q, n = dst[j], normals[j]
        r = ((moved - q) * n).sum(dim=1)               # signed plane residual
        J = torch.cat([torch.linalg.cross(moved, n), n], dim=1)   # (P, 6)
        Jw = J * w[:, None]
        A = Jw.T @ J + 1e-6 * eye6
        b = -Jw.T @ r
        return se3_exp(_solve(A, b)) @ T

    def gicp_step(T):
        """Gauss-Newton on rᵀ (C_q + R C_p Rᵀ)⁻¹ r."""
        moved, j, _, w = correspondences(T)
        q = dst[j]
        R = T[:3, :3]
        Cs = torch.einsum("ab,pbc,dc->pad", R, cov_src, R)
        M = torch.linalg.inv_ex(cov_dst[j] + Cs + 1e-9 * eye3,
                                check_errors=False)[0]           # (P, 3, 3)
        r = moved - q
        x, y, z = moved[:, 0], moved[:, 1], moved[:, 2]
        zero = torch.zeros_like(x)
        # J = [ -[moved]ₓ | I ] per point, (P, 3, 6)
        Jr = torch.stack([torch.stack([zero, z, -y], dim=-1),
                          torch.stack([-z, zero, x], dim=-1),
                          torch.stack([y, -x, zero], dim=-1)], dim=1)
        J = torch.cat([Jr, eye3.expand_as(Jr)], dim=2)
        MJ = torch.einsum("pij,pjb->pib", M, J)
        A = torch.einsum("p,pia,pib->ab", w, J, MJ) + 1e-9 * eye6
        b = -torch.einsum("p,pib,pi->b", w, MJ, r)
        return se3_exp(_solve(A, b)) @ T

    step = {"p2p": p2p_step, "p2l": p2l_step, "gicp": gicp_step}[mode]
    T = init_T
    for _ in range(max_iterations):
        T = step(T)
    _, _, dist, w = correspondences(T)
    inliers = w.sum()
    fitness = inliers / n_src
    rmse = torch.sqrt((w * dist ** 2).sum() / inliers.clamp(min=1e-6))
    return T, fitness, rmse


class PreparedCloud:
    """Per-cloud verification state, computed once per cloud: the
    downsampled points plus the GICP covariances or point-to-plane normals
    (and, for the torch backend, the padded device tensors). On a card
    ``ready`` is the CUDA event after which those tensors are written (on
    the verifier's stream); None for tensors made elsewhere, which a
    registration then orders after its caller's current stream."""

    __slots__ = ("pts", "cov", "normals", "padded", "mask", "ready")

    def __init__(self, pts, cov=None, normals=None, padded=None, mask=None,
                 ready=None):
        self.pts = pts
        self.cov = cov
        self.normals = normals
        self.padded = padded
        self.mask = mask
        self.ready = ready


_STREAMS: Dict[int, tuple] = {}       # device index → (stream, lock)
_STREAMS_LOCK = threading.Lock()


def verifier_stream(device: torch.device) -> tuple:
    """(stream, lock): the CUDA stream every torch-backend verifier of
    ``device`` prepares and registers on, apart from the current stream on
    which the serving graphs replay (a multi-millisecond registration there
    would sit in front of the next keyframe's step), and the re-entrant
    lock that its users hold while they enqueue: a capture on the stream
    must take in no other thread's launches."""
    idx = device.index if device.index is not None else 0
    with _STREAMS_LOCK:
        if idx not in _STREAMS:
            _STREAMS[idx] = (torch.cuda.Stream(device), threading.RLock())
        return _STREAMS[idx]


STATS = {"captures": 0, "replays": 0, "eager_steps": 0}


class RegistrationExecutable:
    """JAX's jitted ``_icp_kernel`` for one (device, mode, P, Q, iterations,
    max correspondence): the static registration step, its input and
    output buffers and, on a card, its CUDA graph.

    The inputs live in static arenas (``utils/graph_exec.Arena``): the
    clouds (``src``, ``src_mask``, ``dst``, ``dst_mask``, and ``normals``
    for "p2l" or ``cov_src`` and ``cov_dst`` for "gicp") on the device
    only, filled by device-to-device copies from the two
    ``PreparedCloud``s, and ``init_T`` staged through a pinned buffer. The
    output is one (18,) float32 section, T row-major, fitness and RMSE,
    fetched with one copy into pinned memory.

    On a card ``run`` enqueues on the verifier's stream: the copies, then
    on its first call the step once and its capture (in the executable's
    own memory pool, ``thread_local``, so that the serving graphs of
    another thread may replay and capture meanwhile), then a replay,
    which credits kernel N's 31 launches (and in "p2p" kernel R's 30);
    then the fetch, which the host waits for. A failed build, capture or
    replay raises: there is no fallback to the eager step. ``graphed``
    False runs the same step eagerly on the stream (the comparison path).
    On the CPU the step always runs eagerly. ``lock`` keeps two threads
    from staging one arena at once."""

    def __init__(self, device: torch.device, mode: str, n_src: int,
                 n_dst: int, iterations: int, max_corr: float,
                 graphed: bool):
        if graphed and (device.type != "cuda" or mode not in GRAPH_MODES):
            raise ValueError(f"no graph for mode {mode!r} on {device}")
        self.device, self.mode = device, mode
        self.iterations, self.max_corr = int(iterations), float(max_corr)
        self.graphed = graphed
        f32, b8 = torch.float32, torch.bool
        sections = [("src", (n_src, 3), f32), ("src_mask", (n_src,), b8),
                    ("dst", (n_dst, 3), f32), ("dst_mask", (n_dst,), b8)]
        if mode == "p2l":
            sections.append(("normals", (n_dst, 3), f32))
        elif mode == "gicp":
            sections += [("cov_src", (n_src, 3, 3), f32),
                         ("cov_dst", (n_dst, 3, 3), f32)]
        self.clouds = Arena(sections, device, host=False)
        self.init = Arena([("init_T", (4, 4), f32)], device)
        self.outputs = Arena([("out", (18,), f32)], device)
        self.lock = threading.Lock()
        cuda = device.type == "cuda"
        self._done = torch.cuda.Event() if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if graphed else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.credits: Dict[object, int] = {}
        self.census: Optional[dict] = None
        self.capture_s: Optional[float] = None

    def _step(self) -> None:
        """The body: reads the arenas, writes the output section."""
        c = self.clouds.dev
        with torch.no_grad():
            T, fitness, rmse = icp_kernel(
                c["src"], c["src_mask"], c["dst"], c["dst_mask"],
                c.get("normals"), c.get("cov_src"), c.get("cov_dst"),
                self.init.dev["init_T"], self.iterations, self.mode,
                self.max_corr)
            self.outputs.dev["out"].copy_(
                torch.cat([T.reshape(-1), fitness[None], rmse[None]]))

    def _stage(self, src: PreparedCloud, dst: PreparedCloud, init_T,
               stream, caller) -> None:
        """The pair into the arenas (on ``stream`` on a card, ordered after
        each cloud's ``ready`` event, or after the ``caller`` stream for
        tensors made elsewhere)."""
        parts = [("src", src.padded), ("src_mask", src.mask),
                 ("dst", dst.padded), ("dst_mask", dst.mask)]
        if self.mode == "p2l":
            parts.append(("normals", dst.normals))
        elif self.mode == "gicp":
            parts += [("cov_src", src.cov), ("cov_dst", dst.cov)]
        if stream is not None:
            for prep in (src, dst):
                if prep.ready is not None:
                    stream.wait_event(prep.ready)
                else:
                    stream.wait_stream(caller)
        for name, t in parts:
            want = self.clouds.dev[name]
            if t is None or t.shape != want.shape or t.device != self.device:
                raise ValueError(
                    f"registration ({self.mode}): {name} is "
                    f"{None if t is None else (tuple(t.shape), str(t.device))}"
                    f", the executable takes {tuple(want.shape)} on "
                    f"{self.device}")
            if stream is not None:
                t.record_stream(stream)
            want.copy_(t)
        self.init.np["init_T"][...] = init_T
        self.init.upload()

    def run(self, src: PreparedCloud, dst: PreparedCloud, init_T
            ) -> Tuple[np.ndarray, bool]:
        """Register ``src`` onto ``dst`` from ``init_T`` (4, 4): returns
        the (18,) host output (T row-major, fitness, RMSE) and whether
        this call captured the graph."""
        with self.lock:
            if self.device.type == "cpu":
                self._stage(src, dst, init_T, None, None)
                self._step()
                STATS["eager_steps"] += 1
                return self.outputs.np["out"].copy(), False
            stream, stream_lock = verifier_stream(self.device)
            caller = torch.cuda.current_stream(self.device)
            captured = False
            with stream_lock, torch.cuda.device(self.device), \
                    torch.cuda.stream(stream):
                self._stage(src, dst, init_T, stream, caller)
                if self.graphed and self.graph is None:
                    self._capture(stream)
                    captured = True
                if self.graph is not None:
                    replay(self.graph, self.credits, STATS)
                else:
                    self._step()
                    STATS["eager_steps"] += 1
                self.outputs.download()
                self._done.record(stream)
            self._done.synchronize()       # the pair's one fetch
            return self.outputs.np["out"].copy(), captured

    def _capture(self, stream) -> None:
        from neural_spectral_codec_torch import _build
        from neural_spectral_codec_torch.retrieval import (
            nearest_kernel, pca_kernel)
        graph, credits, self.capture_s = capture_graph(
            self._step, stream, self._pool,
            (nearest_kernel.KERNEL, pca_kernel.KABSCH))
        census = _build.graph_census(graph.raw_cuda_graph())
        solves = self.iterations if self.mode == "p2p" else 0
        if census["nearest"] != self.iterations + 1 or \
                census["nearest_cluster_width"] != nearest_kernel.CLUSTER \
                or census["kabsch"] != solves:
            raise RuntimeError(
                f"the registration graph holds {census['nearest']} "
                f"nearest-neighbour searches of cluster width "
                f"{census['nearest_cluster_width']} and {census['kabsch']} "
                f"Kabsch solves, not {self.iterations + 1} of "
                f"{nearest_kernel.CLUSTER} and {solves} ({census})")
        self.graph, self.credits, self.census = graph, credits, census
        STATS["captures"] += 1


_EXECUTABLES = ExecutableCache()


def registration_executable(device: torch.device, mode: str, n_src: int,
                            n_dst: int, iterations: int, max_corr: float,
                            use_graph: bool = True
                            ) -> RegistrationExecutable:
    """The cached executable of (device, mode, P, Q, iterations, max
    correspondence, graphed), made on a miss; graphed on a card unless
    ``use_graph`` is False."""
    graphed = (use_graph and device.type == "cuda"
               and mode in GRAPH_MODES)
    key = (str(device), mode, int(n_src), int(n_dst), int(iterations),
           float(max_corr), graphed)
    return _EXECUTABLES.get(key, lambda: RegistrationExecutable(
        device, mode, n_src, n_dst, iterations, max_corr, graphed))


def cached_executables() -> list:
    """The registration executables made so far, oldest first."""
    return _EXECUTABLES.values()


PREPARE_STATS = {"captures": 0, "replays": 0, "eager_steps": 0}
PREPARE_POOL = SharedPool()     # its graph pool; the stream is the verifier's


class PrepareExecutable(GraphStep):
    """JAX's jitted ``_knn_covariances`` or ``_knn_normals`` for one
    (device, mode, P, k, ε): the padded cloud and its mask in a pinned
    input arena, the normals (P, 3) or covariances (P, 3, 3) in an output
    arena, and on a card the step between them (kernel K, then kernel C
    writing the output section) captured into a CUDA graph in
    ``PREPARE_POOL``. Mode None (point-to-point) computes nothing: the
    run is the upload and the copies.

    ``run`` stages and uploads the cloud (one copy), replays the graph (a
    capture on the first run) or runs the step eagerly (``use_graph``
    False, the comparison path), and copies the points, the mask and the
    output into tensors of their own, which the ``PreparedCloud`` keeps
    (``two_stage``'s cache holds them past the next run), all on the
    verifier's stream under its lock and in no order with the caller's
    stream: they carry the event after which they are written. A failed
    build, capture or replay raises: there is no fallback to ``eigh`` or
    to the eager step. On the CPU the step runs eagerly with the kernels'
    plain versions."""

    def __init__(self, device: torch.device, mode: Optional[str], n: int,
                 k: int, eps: float, use_graph: bool):
        super().__init__(device, use_graph and mode is not None,
                         PREPARE_POOL, PREPARE_STATS)
        self.mode, self.k, self.eps = mode, int(k), float(eps)
        f32 = torch.float32
        self.inputs = Arena([("pts", (n, 3), f32),
                             ("mask", (n,), torch.bool)], device)
        shape = {None: (0,), "normals": (n, 3), "covariances": (n, 3, 3)}
        self.outputs = Arena([("out", shape[mode], f32)], device, host=False)
        self.lock = threading.Lock()

    def _step(self) -> None:
        if self.mode is None:
            return
        from neural_spectral_codec_torch.retrieval.knn_kernel import knn
        from neural_spectral_codec_torch.retrieval.pca_kernel import knn_pca
        p, m = self.inputs.dev["pts"], self.inputs.dev["mask"]
        with torch.no_grad():
            knn_pca(p, knn(p, m, self.k), self.mode, self.eps,
                    out=self.outputs.dev["out"])

    def _kernels(self) -> tuple:
        from neural_spectral_codec_torch.retrieval import (
            knn_kernel, pca_kernel)
        return knn_kernel.KERNEL, pca_kernel.KNN_PCA

    def _check(self, graph: torch.cuda.CUDAGraph) -> None:
        from neural_spectral_codec_torch import _build
        census = _build.graph_census(graph.raw_cuda_graph())
        if census["knn"] != 1 or census["knn_pca"] != 1:
            raise RuntimeError(
                f"the prepare graph holds {census['knn']} k-NN searches and "
                f"{census['knn_pca']} k-NN PCAs, not one of each ({census})")
        self.census = census

    def run(self, padded: np.ndarray, mask: np.ndarray) -> tuple:
        """(points, mask, normals or covariances or None, ready event or
        None, whether this run captured the graph) for one padded
        cloud."""
        with self.lock:
            if self.device.type != "cuda":
                self._stage({"pts": padded, "mask": mask})
                self._step()
                self.stats["eager_steps"] += self.mode is not None
                return self._owned() + (None, False)
            stream, stream_lock = verifier_stream(self.device)
            captured = False
            with stream_lock, torch.cuda.device(self.device), \
                    torch.cuda.stream(stream):
                self._uploaded.synchronize()
                self._stage({"pts": padded, "mask": mask})
                self.inputs.upload()
                self._uploaded.record(stream)
                if self.use_graph and self.graph is None:
                    self._capture(stream)
                    captured = True
                if self.graph is not None:
                    replay(self.graph, self.credits, self.stats)
                elif self.mode is not None:
                    self._step()
                    self.stats["eager_steps"] += 1
                owned = self._owned()
                ready = torch.cuda.Event()
                ready.record(stream)
            return owned + (ready, captured)

    def _owned(self) -> tuple:
        out = None if self.mode is None else self.outputs.dev["out"].clone()
        return (self.inputs.dev["pts"].clone(),
                self.inputs.dev["mask"].clone(), out)


_PREPARES = ExecutableCache()


def prepare_executable(device: torch.device, method: str, n: int, k: int,
                       eps: float, use_graph: bool = True
                       ) -> PrepareExecutable:
    """The cached prepare executable of (device, what ``method`` computes,
    P, k, ε, graphed), made on a miss."""
    mode = PREPARE_MODES[method]
    if mode is None:
        k, eps = 0, 0.0
    elif mode == "normals":
        k, eps = NORMALS_KNN, 0.0
    graphed = use_graph and device.type == "cuda" and mode is not None
    key = (str(device), mode, int(n), int(k), float(eps), graphed)
    return _PREPARES.get(key, lambda: PrepareExecutable(
        device, mode, n, k, eps, graphed))


def cached_prepares() -> list:
    """The prepare executables made so far, oldest first."""
    return _PREPARES.values()


def _scratch_cloud() -> np.ndarray:
    """A fixed cloud for warm-up: a 20 m ground square and two walls at a
    0.4 m pitch: 3,500 points in 3,391 voxels of 0.3 m."""
    a = np.arange(-10.0, 10.0, 0.4)
    h = np.arange(0.0, 4.0, 0.4)
    gx, gy = np.meshgrid(a, a)
    ground = np.column_stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)])
    wx, wz = np.meshgrid(a, h)
    wall1 = np.column_stack([wx.ravel(), np.full(wx.size, 6.0), wz.ravel()])
    wall2 = np.column_stack([np.full(wx.size, -7.0), wx.ravel(), wz.ravel()])
    return np.vstack([ground, wall1, wall2]).astype(np.float32)


class GeometricVerifier:
    """``verify(source, target)`` → (verified, transform or None, info);
    either side may be raw (N, 3|4) points or a :class:`PreparedCloud`
    from :meth:`prepare`."""

    def __init__(self, method: str = "gicp", fitness_threshold: float = 0.3,
                 rmse_threshold: float = 0.5, max_iterations: int = 30,
                 voxel_downsample: float = 0.3,
                 max_correspondence_distance: float = 1.0,
                 max_points: int = 4096, backend: str = "auto",
                 gicp_epsilon: float = 1e-3, covariance_knn: int = 20,
                 device: DeviceLike = "cuda", use_graph: bool = True):
        if method not in ("icp", "point_to_plane", "gicp"):
            raise ValueError(f"unknown verification method: {method}")
        self.method = method
        self.gicp_epsilon = gicp_epsilon
        self.covariance_knn = covariance_knn
        self.fitness_threshold = fitness_threshold
        self.rmse_threshold = rmse_threshold
        self.max_iterations = max_iterations
        self.voxel_downsample = voxel_downsample
        self.max_correspondence_distance = max_correspondence_distance
        self.max_points = max_points
        # "auto" is the native library, built here: a failed build raises
        backend = {"auto": "native", "jax": "torch"}.get(backend, backend)
        if backend not in ("native", "torch"):
            raise ValueError(f"unknown verifier backend: {backend}")
        if backend == "native":
            from neural_spectral_codec_torch.native import geom
            geom.load()
        self.backend = backend
        self.device = (resolve_device(device) if self.backend == "torch"
                       else torch.device("cpu"))
        # on a card: one graph replay a cloud and a pair; use_graph False
        # runs the same static steps eagerly
        self.use_graph = use_graph
        self.captures = 0      # prepare and registration graphs it captured
        logger.info("geometric verifier: %s backend, %s, %d points%s",
                    self.backend, method, max_points,
                    "" if self.backend == "native" or
                    self.device.type == "cpu" else
                    ", one graph replay a cloud and a pair" if use_graph
                    else ", eager steps")

    def prepare(self, points: np.ndarray) -> PreparedCloud:
        """Downsample the cloud and compute its covariances or normals."""
        if self.backend == "native":
            from neural_spectral_codec_torch.native import geom
            pts = geom.voxel_downsample(points, self.voxel_downsample)
            if len(pts) > self.max_points:
                pts = pts[np.linspace(0, len(pts) - 1,
                                      self.max_points).astype(int)]
            cov = normals = None
            if len(pts) >= 6:
                cell = 2 * self.voxel_downsample
                if self.method == "gicp":
                    cov = geom.estimate_covariances(
                        pts, k=self.covariance_knn, grid_cell=cell,
                        eps=self.gicp_epsilon)
                elif self.method == "point_to_plane":
                    normals = geom.estimate_normals(pts, k=16,
                                                    grid_cell=cell)
            return PreparedCloud(pts, cov=cov, normals=normals)

        # the host's voxel grid and padding, then one upload and one
        # replay on the verifier's stream (PrepareExecutable)
        pts = voxel_downsample(points, self.voxel_downsample)
        padded, mask = _pad(pts, self.max_points)
        exe = prepare_executable(self.device, self.method, self.max_points,
                                 self.covariance_knn, self.gicp_epsilon,
                                 self.use_graph)
        p, m, out, ready, captured = exe.run(padded, mask)
        self.captures += captured
        return PreparedCloud(
            pts, cov=out if exe.mode == "covariances" else None,
            normals=out if exe.mode == "normals" else None, padded=p,
            mask=m, ready=ready)

    def warmup(self) -> None:
        """Build what the first verification would build, so that none is
        built mid-stream: the native library, or for the torch backend the
        kernels and this method's prepare and registration executables (on
        a card their graphs, captured), by preparing and verifying a
        scratch pair of clouds. Run it before the verifier's worker threads
        start."""
        if self.backend == "native":
            from neural_spectral_codec_torch.native import geom
            geom.load()
            return
        if self.device.type == "cuda":
            from neural_spectral_codec_torch import _build
            _build.load_library()
        cloud = _scratch_cloud()
        shifted = cloud + np.array([0.3, -0.2, 0.0], np.float32)
        self.verify(self.prepare(cloud), self.prepare(shifted))

    def _prep(self, points_or_prepared) -> PreparedCloud:
        if isinstance(points_or_prepared, PreparedCloud):
            return points_or_prepared
        return self.prepare(points_or_prepared)

    def verify(self, source_points, target_points,
               initial_transform: Optional[np.ndarray] = None
               ) -> Tuple[bool, Optional[np.ndarray], Dict]:
        sprep = self._prep(source_points)
        dprep = self._prep(target_points)
        if self.backend == "native":
            T, fitness, rmse = self._register_native(sprep, dprep,
                                                     initial_transform)
        else:
            T, fitness, rmse = self._register_torch(sprep, dprep,
                                                    initial_transform)
        info = {"fitness": fitness, "rmse": rmse,
                "information_matrix": self._information_matrix(fitness)}
        if T is None:
            return False, None, info
        verified = (fitness >= self.fitness_threshold
                    and rmse <= self.rmse_threshold)
        return (True, T, info) if verified else (False, None, info)

    def _register_native(self, sprep, dprep, initial_transform):
        from neural_spectral_codec_torch.native import geom
        src, dst = sprep.pts, dprep.pts
        if len(src) < 6 or len(dst) < 6:
            return None, 0.0, float("inf")
        if self.method == "gicp":
            return geom.gicp(src, dst, sprep.cov, dprep.cov,
                             init=initial_transform,
                             max_iterations=self.max_iterations,
                             max_correspondence=
                             self.max_correspondence_distance)
        return geom.icp(src, dst, normals=dprep.normals,
                        init=initial_transform,
                        max_iterations=self.max_iterations,
                        max_correspondence=self.max_correspondence_distance)

    def _register_torch(self, sprep, dprep, initial_transform):
        init = (np.eye(4, dtype=np.float32) if initial_transform is None
                else np.asarray(initial_transform, np.float32))
        exe = registration_executable(
            self.device, MODES[self.method], sprep.padded.shape[0],
            dprep.padded.shape[0], self.max_iterations,
            self.max_correspondence_distance, self.use_graph)
        out, captured = exe.run(sprep, dprep, init)
        self.captures += captured
        return (out[:16].reshape(4, 4).astype(np.float64), float(out[16]),
                float(out[17]))

    @staticmethod
    def _information_matrix(fitness: float) -> np.ndarray:
        """Diagonal heuristic scaled by fitness: 100 for translation,
        1000 for rotation."""
        info = np.eye(6)
        info[:3, :3] *= 100.0 * fitness
        info[3:, 3:] *= 1000.0 * fitness
        return info


def verify_loop_closure(source_points, target_points, method: str = "gicp",
                        fitness_threshold: float = 0.3,
                        rmse_threshold: float = 0.5,
                        backend: str = "auto", device: DeviceLike = "cuda"):
    """One verification with a fresh verifier."""
    return GeometricVerifier(
        method=method, fitness_threshold=fitness_threshold,
        rmse_threshold=rmse_threshold, backend=backend,
        device=device).verify(source_points, target_points)


def batch_verify_candidates(query_points, candidate_points_list,
                            method: str = "gicp",
                            fitness_threshold: float = 0.3,
                            rmse_threshold: float = 0.5,
                            parallel: bool = False,
                            max_workers: int = 4, backend: str = "auto",
                            device: DeviceLike = "cuda") -> list:
    """Verify many candidates against one query, in input order; with
    ``parallel`` and the native backend, in a thread pool."""
    v = GeometricVerifier(method=method, fitness_threshold=fitness_threshold,
                          rmse_threshold=rmse_threshold, backend=backend,
                          device=device)
    qprep = v.prepare(query_points)
    if parallel and v.backend == "native" and len(candidate_points_list) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(lambda c: v.verify(qprep, c),
                                 candidate_points_list))
    return [v.verify(qprep, c) for c in candidate_points_list]
