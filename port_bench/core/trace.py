"""The traced run: torch.profiler over a steady part of the window, spans
around the program's stage timers, and the shapes of every launch of the
port's two CUDA kernels, reduced to one record that the metric readers
read. All of it lives in the benchmark's files; the program is unchanged."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from dream_yara_tpu_torch.ops.banded_verify_cuda import BandedVerifyKernel
from dream_yara_tpu_torch.ops.row_gather_cuda import RowGatherKernel
from dream_yara_tpu_torch.utils.timer import StageTimers

from . import roofline

VERIFY_KERNEL = "banded_verify_kernel"
GATHER_KERNEL = "row_gather_kernel"


class BenchTimers(StageTimers):
    """The program's stage timers, which also keep each stage's span
    (wall clock ns, the profiler's time base) while `spans` is set."""

    def __init__(self):
        super().__init__()
        self.spans = False
        self.kept: list = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.spans:
            with super().stage(name):
                yield
            return
        t0 = time.time_ns()
        try:
            with super().stage(name):
                yield
        finally:
            with self._lock:
                self.kept.append((t0, time.time_ns(), name))

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.totals)


def warm_profiler(device: torch.device) -> None:
    """Start and stop the profiler once around a trivial launch, so that
    its one-time set-up (CUPTI) is paid in set-up and not in the window."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    torch.ones(1, device=device).add_(1)
    torch.cuda.synchronize(device)
    prof.stop()


class Tracer:
    """The profiler over the traced part of the window, started and
    stopped from the thread that consumes the stream: device activity
    only, so the host pays almost nothing; the stage spans and the kernel
    launches are kept over the same span."""

    def __init__(self, timers: BenchTimers, launches: "LaunchLog"):
        self.timers, self.launches = timers, launches
        self.prof = None
        self.span = None
        self._a = None
        self.start_s = self.stop_s = 0.0

    @property
    def running(self) -> bool:
        return self._a is not None

    def start(self) -> None:
        t = time.perf_counter()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.launches.on = True
        self.timers.spans = True
        self._a = time.time_ns()
        self.start_s = time.perf_counter() - t

    def end_span(self) -> None:
        """Close the traced span: no more spans or launches are kept. The
        profiler runs on until `stop`, after the window, so that stopping
        it (which reads every event) costs the window nothing."""
        self.span, self._a = (self._a, time.time_ns()), None
        self.timers.spans = False
        self.launches.on = False

    def stop(self) -> None:
        t = time.perf_counter()
        if self._a is not None:
            self.end_span()
        torch.cuda.synchronize()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t


class LaunchLog:
    """Wraps the kernels' entry points and keeps each launch's operands
    (references, no copy: nothing runs on the device) while `on` is set."""

    HOLD_BYTES = 1 << 30     # operands kept at most; later launches go unrecorded

    def __init__(self):
        self.on = False
        self.verify: list = []
        self.gather: list = []
        self.held = 0
        self._lock = threading.Lock()
        self._saved = {}

    def _keep(self, lst, item, nbytes):
        with self._lock:
            if self.held + nbytes <= self.HOLD_BYTES:
                self.held += nbytes
                lst.append(item)
            else:
                self.on = False

    def __enter__(self):
        log = self
        v_call, g_call = BandedVerifyKernel.__call__, RowGatherKernel.__call__
        self._saved = {BandedVerifyKernel: v_call, RowGatherKernel: g_call}

        def verify(kself, text, anchors, reads, read_rows, lengths, max_err,
                   lane_bin=None, bin_n=None):
            out = v_call(kself, text, anchors, reads, read_rows, lengths,
                         max_err, lane_bin, bin_n)
            if log.on:
                log._keep(log.verify, (lengths, int(max_err), lane_bin is not None),
                          lengths.numel() * 4)
            return out

        def gather(kself, table, idx):
            out = g_call(kself, table, idx)
            if log.on:
                log._keep(log.gather, (table.shape[0], table.shape[1], idx),
                          idx.numel() * idx.element_size())
            return out

        BandedVerifyKernel.__call__ = verify
        RowGatherKernel.__call__ = gather
        return self

    def __exit__(self, *exc):
        for cls, fn in self._saved.items():
            cls.__call__ = fn
        return False

    def bounds(self):
        """Bound seconds of each kept launch, in launch order:
        (verify bounds, gather bounds)."""
        v = [roofline.verify_bound(lens.cpu().numpy(), E, stacked)[0]
             for lens, E, stacked in self.verify]
        g = []
        for nb, w, idx in self.gather:
            distinct = int(torch.unique(idx.clamp(0, nb - 1)).numel())
            g.append(roofline.gather_bound(distinct, w, idx.numel(),
                                           idx.element_size())[0])
        return v, g


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(tracer: Tracer) -> dict:
    """The trace record: the traced span, device busy time, kernel time by
    name, the kernels' bound sums and the idle gaps by host stage."""
    if tracer.prof is None or tracer.span is None:
        return {}
    a, b = tracer.span
    dev = []
    for e in tracer.prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s = _ns(e, "start")
            dev.append((s, s + _ns(e, "duration"), e.name()))
    if not dev:
        return {}
    lead = (min(s for s, _, _ in dev) - a) * 1e-9   # the clocks' agreement
    clipped = [(max(s, a), min(e, b), n) for s, e, n in dev if e > a and s < b]
    busy = _union([(s, e) for s, e, _ in clipped])
    busy_ns = sum(e - s for s, e in busy)
    by_name = defaultdict(float)
    for s, e, n in clipped:
        by_name[n] += (e - s) * 1e-9
    v_bound, g_bound = tracer.launches.bounds()
    kern = {}
    for key, bounds in ((VERIFY_KERNEL, v_bound), (GATHER_KERNEL, g_bound)):
        # the kernels of the launches kept: the first as many as were kept
        # that started in the span, in order (one stream runs them in order)
        starts = sorted((s, e) for s, e, n in dev if key in n and s >= a)
        mine = starts[: len(bounds)]
        kern[key] = {"launches": len(bounds), "kernels": len(mine),
                     "bound_s": sum(bounds[: len(mine)]),
                     "kernel_s": sum(e - s for s, e in mine) * 1e-9}
    gaps, t = [], a
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < b:
        gaps.append((t, b))
    idle_by = defaultdict(float)
    kept = tracer.timers.kept
    if gaps:
        g = np.array(gaps, np.int64)
        if kept:
            st = np.array([(s, e) for s, e, _ in kept], np.int64)
            names = [n for _, _, n in kept]
            for c0 in range(0, len(g), 2048):
                gs, ge = g[c0 : c0 + 2048, :1], g[c0 : c0 + 2048, 1:]
                ov = np.minimum(st[None, :, 1], ge) - np.maximum(st[None, :, 0], gs)
                best = ov.argmax(1)
                for (s0, e0), j, o in zip(g[c0 : c0 + 2048], best,
                                          ov[np.arange(len(best)), best]):
                    idle_by[names[j] if o > 0 else "(no stage)"] += (e0 - s0) * 1e-9
        else:
            idle_by["(no stage)"] = float((g[:, 1] - g[:, 0]).sum()) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (b - a) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "events": len(dev),
        "profiler_start_s": tracer.start_s,
        "profiler_stop_s": tracer.stop_s,
        "first_event_after_start_s": lead,
        "device_ops": [[n, s] for n, s in top],
        "idle_gaps": [[n, s] for n, s in
                      sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]],
        "verify": kern[VERIFY_KERNEL],
        "gather": kern[GATHER_KERNEL],
    }
