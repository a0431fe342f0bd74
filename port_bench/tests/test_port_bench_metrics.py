"""Each per-layer reader on a synthetic record, and the trace reduction on
a trace with known busy and idle intervals."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dream_yara_tpu_torch.verify_bench import (GENOME_LEN, SHAPES, STACKED_SHAPES,
                                               bound)
from dream_yara_tpu_torch.verify_cases import edge_case, stacked_case, verify_case
from port_bench.core import roofline, spec, trace

REC = {
    "reads": 2_000_000,
    "timers": {"device wait+fetch": 0.5, "mesh fetch (device wait)": 0.25,
               "ibf classify": 1.0, "repetitive re-seed (device)": 8.0,
               "mesh collect (host)": 3.0, "rank/dedup (host)": 1.0,
               "cigar (host)": 0.5, "select pairs (host)": 0.25,
               "sam write (host)": 2.25, "mate rescue": 9.0},
    "trace": {"window_s": 2.0, "busy_s": 0.5,
              "verify": {"launches": 4, "bound_s": 4e-5, "kernels": 4, "kernel_s": 4e-4},
              "gather": {"launches": 12, "bound_s": 5e-4, "kernels": 10, "kernel_s": 1e-3}},
}
WANT = {"device_wait_s_per_mread": 0.375, "classify_s_per_mread": 0.5,
        "repetitive_s_per_mread": 4.0,
        "host_finish_s_per_mread": 2.0, "verify_roofline_pct": 10.0,
        "gather_roofline_pct": 50.0, "device_idle_pct": 75.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_synthetic_record(name):
    mod = spec.kind(spec.BENCH_DIR, "metrics", name)
    assert mod.read(REC) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", ["verify_roofline_pct", "gather_roofline_pct",
                                  "device_idle_pct"])
def test_trace_readers_find_nothing_without_a_trace(name):
    mod = spec.kind(spec.BENCH_DIR, "metrics", name)
    assert mod.read({**REC, "trace": {}}) is None


def test_every_per_layer_metric_has_its_reader():
    import json
    bm = json.loads((spec.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    for m in bm["per_layer"]:
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()


def test_a_suffixed_metric_reads_with_the_reader_of_its_quantity():
    mod = spec.reader(spec.BENCH_DIR, "host_finish_s_per_mread.mesh")
    assert mod.read(REC) == pytest.approx(WANT["host_finish_s_per_mread"])


class _Ev:
    def __init__(self, name, start, dur, cuda=True):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU


def test_reduce_finds_a_known_idle_gap():
    ms = 1_000_000
    events = [_Ev("row_gather_kernel<int>", 0, 2 * ms),
              _Ev("Memcpy DtoH", 1 * ms, 2 * ms),          # overlaps the gather
              _Ev("banded_verify_kernel<3>", 10 * ms, 5 * ms),
              _Ev("cudaLaunchKernel", 4 * ms, 1 * ms, cuda=False)]
    timers = SimpleNamespace(kept=[(3 * ms, 9 * ms, "sam write (host)"),
                                   (15 * ms, 20 * ms, "cigar (host)")])
    launches = SimpleNamespace(bounds=lambda: ([1e-3], [1e-3, 5e-4]))
    tr = SimpleNamespace(
        prof=SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events))),
        span=(0, 20 * ms), timers=timers, launches=launches,
        start_s=0.0, stop_s=0.0)
    rec = trace.reduce(tr)
    assert rec["window_s"] == pytest.approx(0.020)
    assert rec["busy_s"] == pytest.approx(0.008)           # [0, 3) and [10, 15) ms
    gaps = dict(rec["idle_gaps"])
    assert gaps["sam write (host)"] == pytest.approx(0.007)  # [3, 10) ms
    assert gaps["cigar (host)"] == pytest.approx(0.005)      # [15, 20) ms
    assert rec["verify"] == {"launches": 1, "kernels": 1, "bound_s": 1e-3,
                             "kernel_s": pytest.approx(0.005)}
    # two gathers kept, one kernel in the trace: the first bound only
    assert rec["gather"] == {"launches": 2, "kernels": 1, "bound_s": 1e-3,
                             "kernel_s": pytest.approx(0.002)}
    assert spec.kind(spec.BENCH_DIR, "metrics", "verify_roofline_pct").read(
        {"trace": rec}) == pytest.approx(20.0)
    idle = spec.kind(spec.BENCH_DIR, "metrics", "device_idle_pct").read({"trace": rec})
    assert idle == pytest.approx(60.0)


def _smoke_lengths():
    """The lane lengths of verify_bench's smoke shapes, made as it makes them."""
    text = np.random.default_rng(12345).integers(0, 4, GENOME_LEN).astype(np.int8)
    rng = np.random.default_rng(7)
    for C, L, E, edges in SHAPES:
        case = verify_case(rng, text, C, L, E)
        if edges:
            case = edge_case(text, *case)
        yield E, False, np.asarray(case[3])
    rng = np.random.default_rng(5)
    for _what, lens, C, L, E, edges in STACKED_SHAPES:
        yield E, True, np.asarray(stacked_case(rng, lens, C, L, E, edges)[6])


def test_frozen_verify_bound_equals_the_ports():
    n = 0
    for E, stacked, lengths in _smoke_lengths():
        t, by, nbytes, ops = roofline.verify_bound(lengths, E, stacked)
        ms, by2, nbytes2, ops2 = bound(lengths, E, stacked)
        assert (by, nbytes, ops) == (by2, nbytes2, ops2)
        assert t * 1e3 == pytest.approx(ms, rel=1e-12)
        n += 1
    assert n == len(SHAPES) + len(STACKED_SHAPES)


def test_gather_bound_counts_distinct_rows_once():
    t, nbytes = roofline.gather_bound(100, 24, 1000, 4)
    assert nbytes == 100 * 96 + 1000 * 4 + 1000 * 96
    assert t == pytest.approx(nbytes / 3.35e12)
