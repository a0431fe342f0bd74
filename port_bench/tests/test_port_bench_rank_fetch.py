"""The reader of `repetitive_rank_fetch_pct`: on synthetic records, on a
record of a program without the rank-row counters (nothing, no error),
and on a tiny cell's stream traced on the CPU, where the plain edition's
lockstep fetches every row it counts (100 %)."""

from __future__ import annotations

import pytest
import torch

from port_bench.core import cell, spec, trace


def _reader():
    return spec.kind(spec.BENCH_DIR, "metrics", "repetitive_rank_fetch_pct")


@pytest.mark.parametrize("rank_rows,lockstep,want", [
    (1_250_000, 10_000_000, 12.5), (0, 4_000, 0.0), (4_000, 4_000, 100.0)])
def test_reader_on_a_synthetic_record(rank_rows, lockstep, want):
    rec = {"reads": 2_000_000, "trace": {},
           "timers": {"repetitive rank rows": rank_rows,
                      "repetitive lockstep rows": lockstep,
                      "repetitive re-seed (device)": 40.0}}
    assert _reader().read(rec) == pytest.approx(want)


@pytest.mark.parametrize("timers", [
    {"repetitive re-seed (device)": 40.0, "repetitive groups": 12},
    {"repetitive rank rows": 0, "repetitive lockstep rows": 0}])
def test_reader_finds_nothing_where_no_enum_group_ran(timers):
    assert _reader().read({"reads": 1, "trace": {}, "timers": timers}) is None


def test_the_tiny_cells_traced_stream_counts_the_lockstep(tiny_tree,
                                                           small_rep_groups):
    root, bench, _ = tiny_tree
    c = spec.load("tiny-rr.tiny-se", root, bench)
    assert "repetitive_rank_fetch_pct" in [m["name"] for m in c.per_layer]
    names, seqs, pool, _ = cell.generate(c, 2**31 + 5)
    batches = [cell.to_batch(e) for e in pool]
    path = spec.kind(c.bench_dir, "paths", c.config["path"]).Path(
        names, seqs, c.config, torch.device("cpu"))
    timers = trace.BenchTimers()
    timers.spans = True
    assert len(list(path.stream(iter(batches), timers))) == len(batches)
    t = timers.snapshot()
    rec = {"reads": sum(b.n_reads for b in batches), "trace": {}, "timers": t}
    assert t["repetitive lockstep rows"] > 0
    assert _reader().read(rec) == 100.0
