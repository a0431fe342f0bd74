"""Per-stage wall-clock accumulators (analog of reference src/misc_timer.h
Timer<> [U]), and the port's tracing on top of them.

`StageTimers.spans` is the one switch. While it is set:
- each stage is also a `torch.profiler.record_function` range, so any
  profiler trace holds the program's stages, nested, on their threads, with
  the kernels each launched;
- the pipeline times runs of its device work with CUDA events
  (`device_span`) and adds the seconds under "<name> (device time)";
- the pipeline counts its work: `add(name, n)` with an int `n` (the
  counters' names say what they count).
While it is clear, tracing costs a boolean test at each stage, counter and
device span.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

DEVICE_TIME = " (device time)"


class StageTimers:
    """Accumulates wall-clock seconds per named pipeline stage, and the
    counters and device times that the pipeline adds while `spans` is set.

    The reference prints loading/seeding/extension/... times at --verbose;
    we reproduce the same stage report (SURVEY.md §5.1).
    """

    def __init__(self, spans: bool = False):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.spans = spans
        # stages accumulate from concurrent pipeline threads (the device
        # worker and the finisher pool in dis_mapper.dream_map_stream) —
        # the read-modify-write below must be atomic
        self._lock = threading.Lock()

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            if self.spans:
                import torch

                with torch.profiler.record_function(name):
                    yield
            else:
                yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, value):
        """Seconds (a float) to a stage, or a count (an int) to a counter."""
        with self._lock:
            self.totals[name] = self.totals.get(name, 0) + value
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        """Stage seconds, then device times, then counters."""
        stages, device, counters = [], [], []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            if isinstance(total, int):
                counters.append(f"  {name:<36s} {total:12d}")
            elif name.endswith(DEVICE_TIME):
                device.append(f"  {name:<36s} {total:9.3f}s  (x{self.counts[name]})")
            else:
                stages.append(f"  {name:<28s} {total:9.3f}s  (x{self.counts[name]})")
        for head, lines in (("device time (CUDA events):", device),
                            ("counters:", counters)):
            if lines:
                stages += [head, *lines]
        return "\n".join(stages)


class DeviceSpan:
    """The device time of work queued on the current CUDA stream between
    this span's start (its construction) and `stop()`, split into phases
    at `mark(phase)`: a phase runs from the previous boundary to its mark.

    The events are read in `settle()`, which the caller makes after a
    fetch that already waited on work queued behind them, so a span adds
    no host-device synchronisation. It adds "<name> (device time)" and
    "<phase> (device time)" for each phase to the timers."""

    def __init__(self, timers, name: str, stream):
        self._timers, self._name, self._stream = timers, name, stream
        self._start = self._record()
        self._marks = []
        self._end = None

    def _record(self):
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record(self._stream)
        return e

    def mark(self, phase: str) -> None:
        self._marks.append((phase, self._record()))

    def stop(self) -> None:
        self._end = self._record()

    def settle(self) -> None:
        if self._end is None:
            return
        add = self._timers.add
        prev = self._start
        for phase, e in self._marks:
            add(phase + DEVICE_TIME, prev.elapsed_time(e) * 1e-3)
            prev = e
        add(self._name + DEVICE_TIME, self._start.elapsed_time(self._end) * 1e-3)
        self._end = None


class _NoSpan:
    """The span of untimed work: `mark` is None (a step takes no marks)."""

    mark = None

    def stop(self) -> None:
        pass

    def settle(self) -> None:
        pass


NO_SPAN = _NoSpan()


def device_span(timers, name: str, device, on: bool):
    """A DeviceSpan on `device`'s current stream where `on` (the batch's
    decision, taken from `timers.spans` at its dispatch) and the device
    is a CUDA device; else NO_SPAN, which records nothing."""
    if not on or getattr(device, "type", None) != "cuda":
        return NO_SPAN
    import torch

    return DeviceSpan(timers, name, torch.cuda.current_stream(device))


@contextmanager
def chrome_trace(path, device):
    """Run the body under torch.profiler, on every thread (the CPU activity,
    which holds the stage ranges; on a CUDA device the card's activity
    too), and write the Chrome trace to `path` at the end."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if getattr(device, "type", None) == "cuda":
        acts.append(ProfilerActivity.CUDA)
    # threads the mapping starts (the device worker, the finisher pool) are
    # traced only with this option
    from torch._C._profiler import _ExperimentalConfig

    prof = torch.profiler.profile(
        activities=acts,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(path))
