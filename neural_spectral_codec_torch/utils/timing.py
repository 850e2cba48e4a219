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
  every device operation one call enqueues (after a lead-in, between
  two spin kernels that show whether records were lost, repeating a
  session that lost them).
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
import time
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


MARKER = "spin_kernel"   # the kernel of torch.cuda._sleep
MARKER_CYCLES = 1000     # about half a microsecond
LEAD_IN = 8              # small kernels that open a session; grows
LEAD_IN_MAX = 16384      # when sessions lose records
REPEATED_SESSIONS = 0    # sessions device_ops repeated, this process
LOST_LEAD_IN = 0         # lead-in records the profiler lost, this process


class RecordsLost(RuntimeError):
    """torch.profiler lost device records of every session tried."""


def _profile_device_ops(fn: Callable[[], object], calls: int,
                        lead_in: int, pause_s: float
                        ) -> Optional[List[Tuple[str, float]]]:
    """The device operations of one session around ``calls`` calls of
    ``fn``, or None when the session lost records of them.

    The profiler can lose the first device records of a session. So a
    session opens with ``lead_in`` small kernels, a wait for them and a
    pause of ``pause_s``; then a spin kernel marks the start of ``fn``'s
    calls and a second one their end. The records are taken in the
    order they started; the session counts only if both markers are in
    it, and the lead-in (what started before the first marker) and the
    markers are left out of the list."""
    global LOST_LEAD_IN
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lead = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(lead_in):
            lead.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(pause_s)
        torch.cuda._sleep(MARKER_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    marks = [e.time_range.start for e in dev if MARKER in e.name]
    if len(marks) != 2:
        return None
    LOST_LEAD_IN += lead_in - sum(e.time_range.start < marks[0]
                                  for e in dev)
    return [(e.name, e.time_range.elapsed_us()) for e in dev
            if e.time_range.start > marks[0] and MARKER not in e.name]


def device_ops(fn: Callable[[], object], calls: int = 1,
               tries: int = 8) -> List[Tuple[str, float]]:
    """(name, µs) of every device operation (kernel, copy, memset) that
    ``calls`` calls of ``fn`` enqueue, from ``torch.profiler``.

    On the H100 the profiler loses the first device records of a
    session, none early in a process and, later in a long process, 1 to
    some tens of them in every session (one wrapper call's kernel went
    unrecorded three sessions in a row). So each session opens with a
    lead-in and brackets the calls with two markers
    (``_profile_device_ops``); a session that lost either marker is
    repeated with a lead-in four times as long (up to ``LEAD_IN_MAX``)
    and a longer pause, up to ``tries`` sessions in all, and
    ``RecordsLost`` is raised when none held both. The lead-in that held
    them is where later sessions start (``LEAD_IN``). A ``fn`` that
    enqueues nothing gives []. ``fn`` must not call
    ``torch.cuda._sleep`` itself. ``REPEATED_SESSIONS`` counts the
    sessions repeated and ``LOST_LEAD_IN`` the lead-in records lost."""
    global LEAD_IN, REPEATED_SESSIONS
    _check_cuda()
    for attempt in range(tries):
        lead_in = min(LEAD_IN * 4 ** attempt, LEAD_IN_MAX)
        ops = _profile_device_ops(fn, calls, lead_in,
                                  min(0.002 * 3 ** attempt, 1.0))
        if ops is not None:
            LEAD_IN = lead_in
            return ops
        REPEATED_SESSIONS += 1
    raise RecordsLost(f"torch.profiler lost device records in "
                      f"{tries} sessions in a row")


def kernel_device_ms(fn: Callable[[], object], names: Sequence[str],
                     calls: int = 50,
                     warmup: int = 3) -> Tuple[Optional[float], int]:
    """(device ms per call of the kernels named, their launches) over
    ``calls`` calls of ``fn``; (None, 0) when the profiler records no
    device time for them (or lost every session's records)."""
    for _ in range(warmup):
        fn()
    try:
        ops = [us for name, us in device_ops(fn, calls)
               if any(n in name for n in names)]
    except RecordsLost:
        return None, 0
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
