"""Per-stage wall-clock accumulators (analog of reference src/misc_timer.h Timer<> [U])."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class StageTimers:
    """Accumulates wall-clock seconds per named pipeline stage.

    The reference prints loading/seeding/extension/... times at --verbose;
    we reproduce the same stage report (SURVEY.md §5.1).
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        # stages accumulate from concurrent pipeline threads (the device
        # worker and the finisher pool in dis_mapper.dream_map_stream) —
        # the read-modify-write below must be atomic
        self._lock = threading.Lock()

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.add(name, dt)

    def add(self, name: str, seconds: float):
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + 1

    def merge(self, other: "StageTimers"):
        for k, v in other.totals.items():
            self.add(k, v)

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<28s} {total:9.3f}s  (x{self.counts[name]})")
        return "\n".join(lines)
