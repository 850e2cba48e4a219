"""Device timing with CUDA events.

Two forms, both on the current CUDA stream and both after warm-up calls:

- ``time_ms``: the median over ``calls`` calls of ``fn``, each between its
  own pair of events (``end.synchronize()`` after each). Right for calls of
  a tenth of a millisecond and more.
- ``time_loop_ms``: ``n`` calls of ``fn`` back to back between ONE pair of
  events, divided by ``n``; the median over ``repeats`` such loops. For
  kernels in the microsecond range, where one event pair per call would
  measure the launch gap as much as the kernel.

Both need a CUDA device; there is no host-clock fallback. ``gpu_label``
names the card a number was taken on.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable

import torch


def gpu_label() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _check_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA-event timing needs a CUDA device")


def time_ms(fn: Callable[[], object], calls: int = 25,
            warmup: int = 3) -> float:
    """Median time of one call of ``fn`` in ms, each call timed alone."""
    _check_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, end = _events()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_loop_ms(fn: Callable[[], object], n: int = 100, repeats: int = 5,
                 warmup: int = 3) -> float:
    """Time of one call of ``fn`` in ms: the median over ``repeats`` loops
    of ``n`` calls, each loop between one pair of events."""
    _check_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = _events()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)
