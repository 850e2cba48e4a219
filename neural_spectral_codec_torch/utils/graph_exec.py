"""Pieces shared by the port's static-shape executables, which run one step
as one captured CUDA graph on a card: the serving step
(``models/serving.py``), the verifier's registration
(``retrieval/verification.py``), the stage-1 query
(``retrieval/retriever.py``), the split-mode eval forward
(``models/gnn.py``), ``entry()``'s forward (``entry.py``) and the training
programs: the miner's chunk (``training/miner.py``), the train step
(``training/trainer.py``) and validation's two scans
(``training/validation.py``).

``Arena``: named typed sections of one device buffer, staged through one
pinned host buffer of the same layout. ``capture_graph``: one warm-up run
of a step on a stream, then its capture into a ``torch.cuda.CUDAGraph``,
with the launch counts of the hand-written kernels the capture recorded
(a replay never runs the wrappers, so ``replay`` credits them).
``SharedPool``: one graph memory pool, stream and lock a device for a
family of graphs. ``ExecutableCache``: executables by key, holding what
they read by address weakly. ``GraphStep``: the form of the last three
(stage, run, fetch under the pool's lock, on the pool's stream).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_ALIGN = 16    # bytes: every section of an arena starts 16-byte aligned


class Arena:
    """Named typed sections of one byte buffer on ``device`` (``dev``) and,
    on a card, of one pinned host buffer of the same layout (``np``: numpy
    views of it); on the CPU the two are one buffer. ``host=False`` keeps
    no host buffer on a card (sections filled on the device only; ``np``
    is then empty)."""

    def __init__(self, sections: Sequence[Tuple[str, tuple, torch.dtype]],
                 device: torch.device, host: bool = True):
        offsets, total = [], 0
        for _, shape, dtype in sections:
            offsets.append(total)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            total += -(-nbytes // _ALIGN) * _ALIGN
        self.dev_bytes = torch.zeros(total, dtype=torch.uint8, device=device)
        if device.type == "cpu":
            self.host_bytes = self.dev_bytes
        elif host:
            self.host_bytes = torch.zeros(total, dtype=torch.uint8,
                                          pin_memory=True)
        else:
            self.host_bytes = None

        def views(buf):
            return {name: buf[off:off + int(np.prod(shape, dtype=np.int64))
                              * dtype.itemsize].view(dtype).view(shape)
                    for (name, shape, dtype), off in zip(sections, offsets)}

        self.dev = views(self.dev_bytes)
        self.np = ({} if self.host_bytes is None else
                   {name: t.numpy()
                    for name, t in views(self.host_bytes).items()})

    def upload(self) -> None:
        """Host sections → device sections: one copy (none on the CPU)."""
        if (self.host_bytes is not None
                and self.host_bytes is not self.dev_bytes):
            self.dev_bytes.copy_(self.host_bytes, non_blocking=True)

    def download(self) -> None:
        """Device sections → host sections: one copy (none on the CPU)."""
        if (self.host_bytes is not None
                and self.host_bytes is not self.dev_bytes):
            self.host_bytes.copy_(self.dev_bytes, non_blocking=True)


def capture_graph(step: Callable[[], None], stream: torch.cuda.Stream,
                  pool, kernels: Sequence, generators: Sequence = (),
                  track: Optional[Callable[[object], None]] = None
                  ) -> Tuple[torch.cuda.CUDAGraph, Dict[object, int], float]:
    """Run ``step`` once on ``stream`` (which fills the per-stream scratch,
    cached tables and library workspaces its launches use), then capture
    it on ``stream`` into a ``CUDAGraph`` in memory ``pool``, in
    ``thread_local`` mode (other threads may launch, and capture into
    other pools, meanwhile). ``generators`` (CUDA ``torch.Generator``s the
    step draws from, other than the device's default one) are registered
    with the graph, so that each replay draws the numbers the next eager
    step would and advances them as that step would. ``track`` is given
    the graph before its capture (``SharedPool.track``).

    Returns (graph, credits, capture seconds). ``credits`` maps each of
    ``kernels`` (``_build.CudaKernel``) that launched inside the capture to
    its launches there, which every replay adds; the capture's own
    launches are taken back out of the counters. A failed capture
    raises."""
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        step()
    before = [(k.launches, k.last_args) for k in kernels]
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    if track is not None:
        track(graph)
    for gen in generators:
        graph.register_generator_state(gen)
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        step()
    graph.instantiate()
    seconds = time.perf_counter() - t0
    credits = {}
    for k, (launches, last_args) in zip(kernels, before):
        if k.launches != launches:
            credits[k] = k.launches - launches
        k.launches, k.last_args = launches, last_args
    return graph, credits, seconds


def replay(graph: torch.cuda.CUDAGraph, credits: Dict[object, int],
           stats: Dict[str, int]) -> None:
    """Replay ``graph`` on the current stream, credit the hand-written
    kernels it holds (``capture_graph``'s credits) and count the replay."""
    graph.replay()
    for kernel, n in credits.items():
        kernel.launches += n
    stats["replays"] += 1


def _device_key(device: torch.device):
    if device.type != "cuda":
        return device.type
    return device.index if device.index is not None else 0


class SharedPool:
    """One CUDA-graph memory pool, one stream and one re-entrant lock for
    each device, shared by a family of graphs whose temporaries never
    outlive a replay (their outputs live in arenas allocated outside the
    pool). Graphs of one pool must never run at the same time: a family
    either replays on one thread's stream only (the serving graphs), or
    captures and replays on the pool's stream under its lock
    (``GraphStep``). On the CPU only the lock exists.

    The allocator refuses a capture into a pool whose graphs have all been
    freed (its memory may then be returned to the card), so the graphs
    captured into the pool are counted while they live (``track``) and,
    once the last one is gone, the next capture gets a new pool."""

    def __init__(self):
        self._by_device: Dict[object, list] = {}
        self._live: Dict[tuple, int] = {}     # (device, pool) -> graphs
        self._guard = threading.RLock()

    def _get(self, device: torch.device) -> list:
        key = _device_key(device)
        cuda = device.type == "cuda"
        with self._guard:
            if key not in self._by_device:
                self._by_device[key] = [
                    None, torch.cuda.Stream(device) if cuda else None,
                    threading.RLock()]
            entry = self._by_device[key]
            if cuda and entry[0] is None:
                entry[0] = torch.cuda.graph_pool_handle()
            return entry

    def handle(self, device: torch.device):
        """The pool the next capture on ``device`` goes into."""
        return self._get(device)[0]

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        return self._get(device)[1]

    def lock(self, device: torch.device) -> threading.RLock:
        return self._get(device)[2]

    def track(self, device: torch.device, handle, graph) -> None:
        """Count ``graph``, made for a capture into pool ``handle`` on
        ``device``, while it lives; when the last graph of the device's
        current pool is gone, that pool is not handed out again."""
        key = (_device_key(device), tuple(handle))
        with self._guard:
            self._live[key] = self._live.get(key, 0) + 1
        weakref.finalize(graph, self._untrack, key)

    def _untrack(self, key: tuple) -> None:
        with self._guard:
            self._live[key] -= 1
            if self._live[key]:
                return
            del self._live[key]
            entry = self._by_device.get(key[0])
            if entry is not None and entry[0] is not None and \
                    tuple(entry[0]) == key[1]:
                entry[0] = None

    def bytes(self, device: torch.device) -> int:
        """Bytes the allocator holds in this family's pools on
        ``device``."""
        key = _device_key(device)
        if device.type != "cuda" or key not in self._by_device:
            return 0
        with self._guard:
            pools = {p for k, p in self._live if k == key}
            if self._by_device[key][0] is not None:
                pools.add(tuple(self._by_device[key][0]))
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if seg["device"] == key
                   and tuple(seg["segment_pool_id"]) in pools)


class ExecutableCache:
    """Executables by key, as JAX caches its compiled programs. Each entry
    holds its ``owners`` (the model, the retriever: objects its step reads
    by address) weakly, and optionally ``buffers`` = (owner, key of the
    buffers it reads). A lookup that misses first drops the entries whose
    owner no longer exists and those of the same buffer owner on other
    buffers (a retriever whose rows were reallocated), then makes one."""

    def __init__(self):
        self._entries: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()

    def get(self, key: tuple, make: Callable[[], object],
            owners: Sequence[object] = (), buffers: Optional[tuple] = None):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and all(
                    r() is o for r, o in zip(hit[1], owners)):
                return hit[0]
            for k, (_, refs, buf) in list(self._entries.items()):
                stale = (buffers is not None and buf is not None
                         and buf[0]() is buffers[0] and buf[1] != buffers[1])
                if stale or any(r() is None for r in refs):
                    del self._entries[k]
            exe = make()
            self._entries[key] = (
                exe, tuple(weakref.ref(o) for o in owners),
                None if buffers is None
                else (weakref.ref(buffers[0]), buffers[1]))
            return exe

    def values(self) -> List[object]:
        """The cached executables, oldest first."""
        with self._lock:
            return [e for e, _, _ in self._entries.values()]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


class GraphStep:
    """A static step between fixed arenas, run by ``run(values)``: the
    values are staged (host values into the pinned input sections, device
    tensors copied on the device after the one upload), the step runs,
    and the outputs come back with one download (``fetch``) or as device
    copies. On a card with ``use_graph`` the first run captures the step
    into a CUDA graph in ``pool`` and later runs replay it; the capture,
    the replays and the staging run on the pool's stream under its lock,
    which a fetching run holds until its outputs are on the host, so two
    graphs of the pool never run at once. A failed capture raises: there
    is no fallback to the eager step. Without ``use_graph``, or on the
    CPU, the same step runs eagerly (counted in ``stats``).

    Subclasses set ``inputs`` and ``outputs`` (``Arena``) and define
    ``_step`` (reads ``inputs.dev``, writes ``outputs.dev``: static
    shapes, no host sync); ``_kernels`` names the hand-written kernels a
    capture may hold, ``_generators`` the generators it draws from, and
    ``_check`` reads the captured graph back. A step that updates state in
    place (a train step) sets ``warmup_is_the_run``: the capture's warm-up
    run is then the run's step, and the capturing run does not replay.
    ``load`` copies device tensors into sections of another arena the step
    reads (data kept on the device across runs)."""

    inputs: Arena
    outputs: Arena
    warmup_is_the_run = False

    def __init__(self, device: torch.device, use_graph: bool,
                 pool: SharedPool, stats: Dict[str, int]):
        self.device = device
        self.use_graph = use_graph and device.type == "cuda"
        self.pool, self.stats = pool, stats
        cuda = device.type == "cuda"
        self._done = torch.cuda.Event() if cuda else None
        # the last upload's end: the pinned inputs may be rewritten after it
        self._uploaded = torch.cuda.Event() if cuda else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.credits: Dict[object, int] = {}
        self.census: Optional[dict] = None
        self.capture_s: Optional[float] = None

    def _step(self) -> None:
        raise NotImplementedError

    def _kernels(self) -> tuple:
        return ()

    def _generators(self) -> tuple:
        return ()

    def load(self, arena: Arena, values: Dict[str, torch.Tensor]) -> None:
        """Copy ``values`` (tensors on this step's device, or host tensors
        on the CPU) into the sections of ``arena`` (``host=False``) of the
        same names, on the pool's stream under its lock, ordered after the
        caller's work and before the next run."""
        with self.pool.lock(self.device):
            if self.device.type != "cuda":
                for name, value in values.items():
                    arena.dev[name].copy_(value)
                return
            caller = torch.cuda.current_stream(self.device)
            stream = self.pool.stream(self.device)
            with torch.cuda.device(self.device):
                stream.wait_stream(caller)
                with torch.cuda.stream(stream):
                    for name, value in values.items():
                        if value.device != self.device:
                            raise ValueError(
                                f"load {name}: on {value.device}, the step "
                                f"runs on {self.device}")
                        value.record_stream(stream)
                        arena.dev[name].copy_(value)
                caller.wait_stream(stream)

    def _check(self, graph: torch.cuda.CUDAGraph) -> None:
        """Read a captured graph back (``census``) and raise on a fault;
        by default there is nothing to check."""

    def _stage(self, values: Dict[str, object]) -> list:
        """Host values into their pinned sections; returns the device
        tensors, to be copied after the upload."""
        on_device = []
        for name, value in values.items():
            dst = self.inputs.np[name]
            if torch.is_tensor(value) and value.device.type != "cpu":
                if value.device != self.device:
                    raise ValueError(f"input {name} on {value.device}, the "
                                     f"step runs on {self.device}")
                on_device.append((name, value))
                continue
            arr = value.numpy() if torch.is_tensor(value) else np.asarray(
                value)
            if arr.shape != dst.shape:
                raise ValueError(f"input {name}: shape {arr.shape}, the "
                                 f"executable takes {dst.shape}")
            dst[...] = arr
        return on_device

    def run(self, values: Dict[str, object], fetch: bool = True
            ) -> Tuple[Dict[str, object], bool]:
        """Stage ``values`` (every input section, by name), run the step;
        returns (outputs, whether this run captured the graph): numpy
        copies with ``fetch``, else device copies ordered before the
        caller's later work."""
        with self.pool.lock(self.device):
            if self.device.type != "cuda":
                self._stage(values)
                self._step()
                self.stats["eager_steps"] += 1
                out = self.outputs.dev
                return ({k: v.numpy().copy() for k, v in out.items()}
                        if fetch else {k: v.clone() for k, v in out.items()},
                        False)
            caller = torch.cuda.current_stream(self.device)
            stream = self.pool.stream(self.device)
            captured = False
            with torch.cuda.device(self.device):
                self._uploaded.synchronize()
                on_device = self._stage(values)
                stream.wait_stream(caller)
                with torch.cuda.stream(stream):
                    self.inputs.upload()
                    self._uploaded.record(stream)
                    for name, value in on_device:
                        value.record_stream(stream)
                        self.inputs.dev[name].copy_(value)
                    if self.use_graph and self.graph is None:
                        self._capture(stream)
                        captured = True
                    if self.graph is None:
                        self._step()
                        self.stats["eager_steps"] += 1
                    elif not (captured and self.warmup_is_the_run):
                        replay(self.graph, self.credits, self.stats)
                    if fetch:
                        self.outputs.download()
                        self._done.record(stream)
                    else:
                        out = {k: v.clone()
                               for k, v in self.outputs.dev.items()}
                        for v in out.values():
                            v.record_stream(caller)
                caller.wait_stream(stream)
                if fetch:
                    self._done.synchronize()     # the run's one fetch
                    out = {k: v.copy() for k, v in self.outputs.np.items()}
            return out, captured

    def _capture(self, stream: torch.cuda.Stream) -> None:
        pool = self.pool.handle(self.device)
        graph, credits, self.capture_s = capture_graph(
            self._step, stream, pool, self._kernels(), self._generators(),
            track=lambda g: self.pool.track(self.device, pool, g))
        self._check(graph)
        self.graph, self.credits = graph, credits
        self.stats["captures"] += 1
