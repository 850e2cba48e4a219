"""Wall-clock section profiler (port of
``neural_spectral_codec_tpu/utils/profiler.py``).

Named start/stop accumulators, a ``profile()`` context manager and a
percentage summary. ``profile(name, sync=device)`` waits for a CUDA
device before the clock stops, so work that was enqueued asynchronously
is counted in the section that enqueued it; a CPU device needs no wait.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


class Profiler:
    def __init__(self):
        self._start: Dict[str, float] = {}
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # events counted apart from the timed sections (the online loop's
        # serving graphs captured mid-stream, ``midstream_captures``)
        self.events: Dict[str, int] = defaultdict(int)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the event counter ``name``."""
        self.events[name] += n

    def start(self, name: str) -> None:
        self._start[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        if name not in self._start:
            raise KeyError(f"Profiler section never started: {name}")
        dt = time.perf_counter() - self._start.pop(name)
        self.totals[name] += dt
        self.counts[name] += 1
        return dt

    @contextlib.contextmanager
    def profile(self, name: str, sync: Optional[torch.device] = None):
        """Time a section; ``sync`` names the device to wait for before
        the clock stops."""
        self.start(name)
        try:
            yield
        finally:
            if sync is not None and sync.type == "cuda":
                torch.cuda.synchronize(sync)
            self.stop(name)

    def means_ms(self) -> Dict[str, float]:
        """Mean ms per call of each section."""
        return {k: 1e3 * t / max(self.counts[k], 1)
                for k, t in self.totals.items()}

    def summary(self) -> str:
        total = sum(self.totals.values())
        lines = ["=" * 64,
                 f"{'Section':<30s} {'Total (s)':>10s} {'Calls':>7s} "
                 f"{'%':>6s}", "-" * 64]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total > 0 else 0.0
            lines.append(f"{name:<30s} {t:>10.3f} {self.counts[name]:>7d} "
                         f"{pct:>5.1f}%")
        lines.append("=" * 64)
        lines += [f"{name}: {n}" for name, n in sorted(self.events.items())]
        return "\n".join(lines)

    def log_summary(self) -> None:
        for line in self.summary().splitlines():
            logger.info(line)

    def reset(self) -> None:
        self._start.clear()
        self.totals.clear()
        self.counts.clear()
        self.events.clear()
