"""Device timing with CUDA events.

Two forms, both on the current CUDA stream and both after warm-up calls:

- ``time_ms``: the median over ``calls`` calls of ``fn``, each between its
  own pair of events (``end.synchronize()`` after each). Right for calls of
  a tenth of a millisecond and more.
- ``time_loop_ms``: ``n`` calls of ``fn`` back to back between ONE pair of
  events, divided by ``n``; the median over ``repeats`` such loops. For
  kernels in the microsecond range, where one event pair per call would
  measure the launch gap as much as the kernel.

Two more read a kernel's own device time, apart from what its wrapper
enqueues around it and from the host time between launches:

- ``kernel_device_ms``: ``torch.profiler`` over ``calls`` calls; the
  device time of the kernels whose names contain one of ``names``, summed
  and divided by ``calls`` (the primary source). ``device_ops`` lists
  every device operation one call enqueues (repeating a session
  whose device records were lost).
- ``time_queued_ms``: ``n`` calls enqueued behind a spin kernel
  (``torch.cuda._sleep``), so that the host has queued them all before
  the first runs; one pair of events around them, divided by ``n``. Given
  the bare C entry point (``CudaKernel.bare``) it is the cross-check.

All need a CUDA device; there is no host-clock fallback. ``gpu_label``
names the card a number was taken on.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable, List, Optional, Sequence, Tuple

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


_PROFILER_STARTED = False
REPEATED_SESSIONS = 0   # sessions device_ops repeated, this process


def _profile_device_ops(fn: Callable[[], object],
                        calls: int) -> List[Tuple[str, float]]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_ops(fn: Callable[[], object], calls: int = 1,
               tries: int = 3) -> List[Tuple[str, float]]:
    """(name, µs) of every device operation (kernel, copy, memset) that
    ``calls`` calls of ``fn`` enqueue, from ``torch.profiler``.

    On the H100 a session now and then returns no device record at all
    (CUPTI's records lost; seen in a process's early sessions), so the
    first call in a process opens one session around a small kernel
    first, and a session that recorded no device operation is repeated,
    up to ``tries`` sessions in all. A ``fn`` that enqueues nothing
    gives [] after ``tries`` sessions. ``REPEATED_SESSIONS`` counts the
    sessions repeated."""
    global _PROFILER_STARTED, REPEATED_SESSIONS
    _check_cuda()
    if not _PROFILER_STARTED:
        x = torch.zeros(1, device="cuda")
        _profile_device_ops(lambda: x.add_(1.0), 1)
        _PROFILER_STARTED = True
    ops = _profile_device_ops(fn, calls)
    for _ in range(tries - 1):
        if ops:
            break
        REPEATED_SESSIONS += 1
        ops = _profile_device_ops(fn, calls)
    return ops


def kernel_device_ms(fn: Callable[[], object], names: Sequence[str],
                     calls: int = 50,
                     warmup: int = 3) -> Tuple[Optional[float], int]:
    """(device ms per call of the kernels named, their launches) over
    ``calls`` calls of ``fn``; (None, 0) when the profiler records no
    device time for them."""
    for _ in range(warmup):
        fn()
    ops = [us for name, us in device_ops(fn, calls)
           if any(n in name for n in names)]
    if not ops or sum(ops) <= 0.0:
        return None, len(ops)
    return sum(ops) / calls / 1e3, len(ops)


def time_queued_ms(fn: Callable[[], object], n: int = 200, repeats: int = 5,
                   hold_ms: float = 20.0, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` in ms: the median over
    ``repeats`` runs of ``n`` calls enqueued while a spin kernel of about
    ``hold_ms`` holds the stream, one pair of events around the calls."""
    _check_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = int(hold_ms * 2e6)       # at least hold_ms at <= 2 GHz
    times = []
    for _ in range(repeats):
        start, end = _events()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)
