"""The readers of the per-layer metrics that read the program's own
tracing (its device spans and counters, kept by the stage timers while
`spans` is set) on synthetic records; on a record without them, as a
program without that tracing leaves, each finds nothing. And a tiny cell's
stream on the CPU, traced through the benchmark's own timers, gives the
counters those readers read."""

from __future__ import annotations


import pytest
import torch

from port_bench.core import cell, spec, trace

TIMERS = {
    "device-timed reads": 400_000, "classified reads": 500_000,
    "routed read-bins": 1_250_000, "map chunks": 40, "spilled chunks": 6,
    "map step (device time)": 2.0, "map seed search (device time)": 1.5,
    "repetitive stratum 1 (device time)": 20.0,
    "repetitive stratum 2 (device time)": 12.0,
    "repetitive seed search (device time)": 24.0,
    "repetitive group slots": 81_920, "repetitive rows": 20_480,
    "repetitive re-seed (device)": 40.0,
}
WANT = {"map_step_device_s_per_mread": 5.0, "spilled_chunk_pct": 15.0,
        "repetitive_device_s_per_mread": 80.0,
        "repetitive_search_device_s_per_mread": 60.0,
        "repetitive_group_fill_pct": 25.0, "bins_per_read": 2.5}


def _reader(name):
    return spec.kind(spec.BENCH_DIR, "metrics", name)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_synthetic_record(name):
    rec = {"reads": 2_000_000, "timers": dict(TIMERS), "trace": {}}
    assert _reader(name).read(rec) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_without_the_programs_tracing(name):
    """The stage seconds alone, as a program without counters and device
    spans leaves them: no value, and no error."""
    rec = {"reads": 2_000_000, "trace": {},
           "timers": {"repetitive re-seed (device)": 40.0, "ibf classify": 1.0}}
    assert _reader(name).read(rec) is None


def test_numerators_missing_from_the_window_read_as_zero():
    """A window in which no chunk spilled has no "spilled chunks" key."""
    rec = {"reads": 1, "trace": {},
           "timers": {"map chunks": 12, "repetitive group slots": 64}}
    assert _reader("spilled_chunk_pct").read(rec) == 0.0
    assert _reader("repetitive_group_fill_pct").read(rec) == 0.0


def test_bench_timers_switch_the_programs_tracing(tiny_tree, small_rep_groups):
    """The benchmark's `spans`, set on its timers, is the program's switch:
    a tiny cell's batches traced on the CPU give the routing, chunk and
    group counters (no device time: there is no card), and untraced ones
    none."""
    root, bench, _ = tiny_tree
    c = spec.load("tiny-rr.tiny-se", root, bench)
    names, seqs, pool, _ = cell.generate(c, 2**31 + 5)
    batches = [cell.to_batch(e) for e in pool]
    path = spec.kind(c.bench_dir, "paths", c.config["path"]).Path(
        names, seqs, c.config, torch.device("cpu"))
    totals = {}
    for spans in (False, True):
        timers = trace.BenchTimers()
        timers.spans = spans
        assert len(list(path.stream(iter(batches), timers))) == len(batches)
        totals[spans] = timers.snapshot()
    assert "classified reads" not in totals[False]
    rec = {"reads": sum(b.n_reads for b in batches), "trace": {},
           "timers": totals[True]}
    assert totals[True]["classified reads"] == rec["reads"]
    bins = c.config["database"]["bins"]
    assert 1 <= _reader("bins_per_read").read(rec) <= bins
    assert 0 <= _reader("spilled_chunk_pct").read(rec) <= 100
    assert 0 < _reader("repetitive_group_fill_pct").read(rec) <= 100
    for name in ("map_step_device_s_per_mread", "repetitive_device_s_per_mread",
                 "repetitive_search_device_s_per_mread"):
        assert _reader(name).read(rec) is None
