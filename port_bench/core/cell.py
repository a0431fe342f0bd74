"""One run of one cell: set-up, the measured window, the traced part of
the window, and the comparison with the plain reference.

Set-up (`setup_s`, from process start to the start of the window): the
database and the read pool are generated from the seed, the database is
indexed in process, and `warmup` batches of the pool go through the same
stream that the window then drives; the kernels and native libraries load
from the build cache inside the checkout on the way.

The window: the feeder hands the stream the pool's batches over and over,
so the pipeline never drains inside it. It opens at the yield of the last
warm-up batch's SAM and closes at the first yield `seconds` later;
`reads_per_s` counts the reads of every batch yielded in between over
that time (a pair is two reads). SAM stays in memory.

The host probe (`host_probe.py`) is timed twice, outside set-up and the
window: once the program's state is freed, and once the check is done.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from dream_yara_tpu_torch.io.readstore import ReadBatch

from . import spec as specmod
from . import check, host_probe, trace


class Feeder:
    """Cycles through the pool until stopped."""

    def __init__(self, pool):
        self.pool = pool
        self.stop = threading.Event()

    def __iter__(self):
        k = 0
        while not self.stop.is_set():
            yield self.pool[k % len(self.pool)]
            k += 1


def rngs(seed: int):
    """Independent generators for the database, the reads and the sample."""
    return [np.random.default_rng([seed, i]) for i in range(3)]


def generate(cell: specmod.Cell, seed: int):
    """(names, seqs, pool, sample rng) of this cell and seed."""
    r_db, r_reads, r_sample = rngs(seed)
    db = cell.config["database"]
    names, seqs = specmod.kind(cell.bench_dir, "gen", db["kind"]).make(db, r_db)
    pool = specmod.kind(cell.bench_dir, "gen", cell.traffic["kind"]).make(
        cell.traffic, r_reads, names, seqs)
    return names, seqs, pool, r_sample


def to_batch(entry: dict) -> ReadBatch:
    reads = entry["reads"]
    return ReadBatch.from_dense(entry["names"], reads,
                                np.full(len(reads), reads.shape[1], np.int32),
                                paired=entry["paired"])


def run(cell: specmod.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, log) -> dict:
    """Run the cell once; returns the record the result line is made from."""
    names, seqs, pool, r_sample = generate(cell, seed)
    batches = [to_batch(e) for e in pool]
    log(f"[setup] sequences and {len(pool)} batches generated at "
        f"{time.perf_counter() - t_start:.1f} s")
    path = specmod.kind(cell.bench_dir, "paths", cell.config["path"]).Path(
        names, seqs, cell.config, device)
    log(f"[setup] database indexed at {time.perf_counter() - t_start:.1f} s")
    if traced and device.type == "cuda":
        trace.warm_profiler(device)
    P = len(batches)
    warmup = int(cell.traffic["warmup"])
    timers = trace.BenchTimers()
    feeder = Feeder(batches)
    cuda = device.type == "cuda"
    first_sam: dict[int, bytes] = {}
    last_sam: dict[int, bytes] = {}
    sam_differs = 0
    reads = 0
    t0 = t_last = None
    setup_s = None
    base = {}
    tracer = None
    t_trace = 0.0
    rec: dict = {"trace": {}}
    with trace.LaunchLog() as launches:
        stream = path.stream(iter(feeder), timers)
        for k, sam in enumerate(stream):
            now = time.perf_counter()
            i = k % P
            if i not in first_sam:
                first_sam[i] = sam
            elif sam != first_sam[i]:
                sam_differs += 1
            if feeder.stop.is_set():
                continue                       # the drain after the window
            if k == warmup - 1:
                t0 = t_last = now
                setup_s = now - t_start
                base = timers.snapshot()
                log(f"[window] set-up {setup_s:.3f} s; window opens")
                if traced and cuda:
                    tracer = trace.Tracer(timers, launches)
                continue
            if k < warmup:
                continue
            reads += batches[i].n_reads
            t_last = now
            last_sam[i] = sam
            el = now - t0
            if tracer is not None:
                # the traced part: from the first yield after a quarter of
                # the window to the first yield after 40 % more of it, or
                # the window's end
                if tracer.prof is None and 0.25 * seconds <= el < seconds:
                    tracer.start()
                    t_trace = el
                elif tracer.running and (el >= t_trace + 0.4 * seconds
                                         or el >= seconds):
                    tracer.end_span()
            if el >= seconds:
                feeder.stop.set()
                if tracer is not None and tracer.prof is not None:
                    tracer.stop()
                rec["window_s"] = t_last - t0
                rec["timers"] = {k2: v - base.get(k2, 0.0)
                                 for k2, v in timers.snapshot().items()}
                rec["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                     if cuda else 0)
        if tracer is not None:
            if tracer.prof is not None and tracer.stop_s == 0.0:
                tracer.stop()
            rec["trace"] = trace.reduce(tracer)
    if t0 is None or "window_s" not in rec:
        raise RuntimeError("the stream ended before the window closed")
    rec.update(setup_s=setup_s, reads=reads, batches_in_window=len(last_sam),
               counters=path.counters(), sam_differs=sam_differs)
    if rec["trace"]:
        t = rec["trace"]
        log(f"[trace] span {t['window_s']:.3f} s, busy {t['busy_s']:.3f} s, "
            f"{t['events']} device events, the first {t['first_event_after_start_s']:.4f} s "
            f"after the span's start; profiler start {t['profiler_start_s']:.3f} s, "
            f"stop {t['profiler_stop_s']:.3f} s")
    log(f"[window] {reads} reads in {rec['window_s']:.3f} s; "
        f"timers over the window: {rec['timers']}; counters {rec['counters']}")
    # free the program's state before the reference runs
    del path, stream
    if cuda:
        torch.cuda.empty_cache()
    probe_s = [host_probe.probe()]
    # the sample is drawn from the pool batches the window produced
    done = sorted(last_sam)
    t1 = time.perf_counter()
    examples: list = []
    rec["checks"] = check.run(cell, names, seqs, [pool[i] for i in done],
                              [last_sam[i] for i in done], r_sample, examples)
    for ex in examples:
        log(f"[check] read {ex[0]} {ex[1]}: program {ex[2]} mapq {ex[3]}; "
            f"reference {ex[4]} mapq {ex[5]}")
    rec["checks"]["sam_differs"] = sam_differs
    log(f"[check] reference and comparison in {time.perf_counter() - t1:.1f} s; "
        f"{rec['checks']['sampled']} reads sampled, {rec['checks']['capped']} "
        f"capped (held to their best distance alone)")
    rec["host_probe_s"] = probe_s + [host_probe.probe()]
    return rec
