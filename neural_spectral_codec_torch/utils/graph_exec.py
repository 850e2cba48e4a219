"""Pieces shared by the port's static-shape executables, which run one step
as one captured CUDA graph on a card: the serving step
(``models/serving.py``) and the verifier's registration
(``retrieval/verification.py``).

``Arena``: named typed sections of one device buffer, staged through one
pinned host buffer of the same layout. ``capture_graph``: one warm-up run
of a step on a stream, then its capture into a ``torch.cuda.CUDAGraph``,
with the launch counts of the hand-written kernels the capture recorded
(a replay never runs the wrappers, so it credits them).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence, Tuple

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
                  pool, kernels: Sequence
                  ) -> Tuple[torch.cuda.CUDAGraph, Dict[object, int], float]:
    """Run ``step`` once on ``stream`` (which fills the per-stream scratch,
    cached tables and library workspaces its launches use), then capture
    it on ``stream`` into a ``CUDAGraph`` in memory ``pool``, in
    ``thread_local`` mode (other threads may launch, and capture into
    other pools, meanwhile).

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
