"""The port's tracing (utils/timer.py): the counters the pipeline adds
while `StageTimers.spans` is set, each against a count made independently
of it; the SAM with tracing on and off, and with timers objects that have
no switch (the JAX package's, and one with only `stage`, `add` and
`totals`); the stage ranges nested under a CPU torch.profiler; the device
spans' arithmetic on stand-in events; and `mapper_cli --trace`.

The database: a tandem-repeat bin, whose reads overflow their seeds and
spill the verify compaction, and two bins that share repeat copies, so a
read routes to several bins; a blocked IBF routes. Chunks of 256 rows,
dense sub-chunks of 128 reads and repetitive groups of 16 rows keep the
CPU run short and give each bin several chunks and groups."""

from __future__ import annotations

import contextlib
import json
import math
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dream_yara_tpu.utils.timer import StageTimers as JaxStageTimers
from dream_yara_tpu_torch.cli import build_filter, indexer, mapper_cli
from dream_yara_tpu_torch.index.fmindex import FMIndex
from dream_yara_tpu_torch.index.ibf import InterleavedBloomFilter
from dream_yara_tpu_torch.io.fasta import write_fasta
from dream_yara_tpu_torch.io.readstore import ReadBatch
from dream_yara_tpu_torch.io.seqstore import SeqStore
from dream_yara_tpu_torch.pipeline import dis_mapper as tdm
from dream_yara_tpu_torch.pipeline import mapper as tmapper
from dream_yara_tpu_torch.utils import timer as timermod
from dream_yara_tpu_torch.utils.options import MapperOptions
from dream_yara_tpu_torch.utils.simulate import repeat_rich_genome, sample_reads
from dream_yara_tpu_torch.utils.timer import StageTimers
from tests.conftest import mutate

torch.set_num_threads(2)
CPU = torch.device("cpu")
OPTS = MapperOptions(error_rate=0.03, sensitivity="high")


@pytest.fixture(scope="module")
def db():
    """(index, batch): 3 bins behind a blocked IBF; 60 tandem reads, 60
    reads from repeat copies and 30 from anywhere."""
    rng = np.random.default_rng(11)
    unit = rng.integers(0, 4, 50).astype(np.int8)
    tandem = np.concatenate([np.tile(unit, 40),
                             rng.integers(0, 4, 2000).astype(np.int8)])
    g, ann = repeat_rich_genome(rng, 40_000, alu_count=30, tandem_loci=2,
                                n_runs=1)
    texts = [tandem, g[:20_000], g[20_000:]]
    stores = [SeqStore.from_seqs([f"c{b}"], [t]) for b, t in enumerate(texts)]
    fms = [FMIndex.build(st.text) for st in stores]
    ibf = InterleavedBloomFilter.create(3, size_bits=1 << 22, n_hashes=3, k=19)
    for b, st in enumerate(stores):
        ibf.add_kmers(st.text, b)
    reads = [mutate(rng, np.tile(unit, 3)[i % 50 : i % 50 + 100].copy(),
                    n_sub=i % 2) for i in range(50)]
    # two substitutions in each half, none in seeds 1 and 3: the exact
    # seeds overflow, stratum 1 places nothing, so stratum 2 runs
    for i in range(10):
        r = np.tile(unit, 3)[i : i + 100].copy()
        r[[5, 20, 55, 70]] = (r[[5, 20, 55, 70]] + 1) % 4
        reads.append(r)
    rep, _ = sample_reads(rng, g, 60, regions=ann["alu"])
    anywhere, _ = sample_reads(rng, g, 30)
    reads += [*rep, *anywhere]
    batch = ReadBatch.from_reads([f"r{i}" for i in range(len(reads))], reads)
    return tdm.DreamIndex(stores, fms, ibf, "bloom", device=CPU), batch


def _profiled_batch(batch):
    """Reads 45-59, tandem reads that take both strata: the profiler records
    every operator, so its runs take a few reads."""
    ids = np.arange(45, 60)
    return ReadBatch(names=[batch.names[i] for i in ids],
                     seqs=batch.seqs[np.concatenate([ids, batch.n_reads + ids])],
                     lengths=batch.lengths[ids],
                     quals=[batch.quals[i] for i in ids], paired=False)


@pytest.fixture
def small_shapes(monkeypatch):
    monkeypatch.setattr(tmapper, "CHUNK_SIZES", (256,))
    monkeypatch.setattr(tmapper.BinMapper, "DENSE_HALF", 128)
    monkeypatch.setattr(tmapper.BinMapper, "REP_PAD", 16)


@pytest.fixture
def traced(db, small_shapes, monkeypatch):
    """A run with spans on, and what the spies saw: the routing mask, and
    for every repetitive group its chunk's reads, stratum and real rows."""
    index, batch = db
    seen = {"routing": [], "groups": [], "searches": []}
    classify, rep_step = tdm.classify_reads, tmapper.repetitive_map_step

    def classify_spy(*a, **kw):
        m = classify(*a, **kw)
        seen["routing"].append(m)
        return m

    def rep_spy(fm, reads, lengths, rep_rows, rep_mask, **kw):
        # the chunk's reads tensor is kept, so that its id names the chunk
        seen["groups"].append((reads, kw["budget"], int(rep_mask.sum()),
                               rep_rows.shape[0]))
        seen["searches"].append((rep_rows.shape[0], kw["max_errors"],
                                 kw["max_slen_rep"], kw["budget"], kw["indels"]))
        return rep_step(fm, reads, lengths, rep_rows, rep_mask, **kw)

    monkeypatch.setattr(tdm, "classify_reads", classify_spy)
    monkeypatch.setattr(tmapper, "repetitive_map_step", rep_spy)
    timers = StageTimers(spans=True)
    sam = tdm.dream_map_sam(index, batch, OPTS, timers=timers)
    return timers, sam, seen


def test_routing_counters_equal_the_mask(db, traced):
    index, batch = db
    timers, _, seen = traced
    (routing,) = seen["routing"]
    t = timers.totals
    assert t["classified reads"] == batch.n_reads
    assert t["routed read-bins"] == int(routing.sum())
    assert batch.n_reads < t["routed read-bins"] < index.n_bins * batch.n_reads
    assert "device-timed reads" not in t          # no device time on the CPU


def test_chunk_and_spill_counters(db, traced):
    """One chunk a 128 reads of a bin's share; a chunk spills exactly when
    it is verified again dense."""
    timers, _, seen = traced
    (routing,) = seen["routing"]
    half = 256 // 2
    t = timers.totals
    assert t["map chunks"] == sum(math.ceil(n / half)
                                  for n in routing.sum(axis=0) if n)
    assert t["spilled chunks"] == timers.counts["dense re-verify (device)"]
    assert 0 < t["spilled chunks"] < t["map chunks"]
    assert not any(k.endswith(timermod.DEVICE_TIME) for k in t)


def test_repetitive_group_counters(traced):
    """Groups: the sum over bins, chunks and strata of ceil(rows /
    REP_PAD), from the rows each group was given."""
    timers, _, seen = traced
    rows = defaultdict(int)
    for reads, budget, real, _ in seen["groups"]:
        rows[id(reads), budget] += real
    assert {b for _, b in rows} == {1, 2}
    t = timers.totals
    assert t["repetitive groups"] == sum(math.ceil(r / 16) for r in rows.values())
    assert t["repetitive groups"] == len(seen["groups"])
    assert t["repetitive group slots"] == sum(k for *_, k in seen["groups"])
    assert t["repetitive group slots"] == 16 * t["repetitive groups"]
    assert t["repetitive rows"] == sum(rows.values())
    assert t["repetitive rows"] <= t["repetitive group slots"]
    assert timers.counts["repetitive stratum 1 (enum)"] + timers.counts[
        "repetitive stratum 2 (enum)"] == t["repetitive groups"]


def test_rank_row_counters(traced):
    """Each enum group counts the plain lockstep's rank rows for its seeds
    (2 x seeds x layouts x trips, from what the group was given); on the
    CPU the plain edition runs, so the rows fetched are the same."""
    from dream_yara_tpu_torch.ops.approx_search import _layout_tables

    timers, _, seen = traced
    want = 0
    for K, max_err, m, budget, indels in seen["searches"]:
        seeds = K * ((max_err + budget + 1) // (budget + 1))
        want += 2 * seeds * len(_layout_tables(m, budget, indels)[0]) * (
            m + int(indels))
    t = timers.totals
    assert want > 0
    assert t["repetitive lockstep rows"] == want
    assert t["repetitive rank rows"] == want
    assert timers.counts["repetitive rank rows"] == t["repetitive groups"]


class _Minimal:
    """A timers object with nothing but `stage`, `add` and `totals`."""

    def __init__(self):
        self.totals = {}

    def stage(self, name):
        return contextlib.nullcontext()

    def add(self, name, value):
        self.totals[name] = self.totals.get(name, 0) + value


@pytest.mark.parametrize("kind", ["spans off", "jax timers", "minimal timers"])
def test_sam_is_the_same_with_tracing_on_and_off(db, traced, kind):
    index, batch = db
    _, want, _ = traced
    timers = {"spans off": StageTimers, "jax timers": JaxStageTimers,
              "minimal timers": _Minimal}[kind]()
    assert tdm.dream_map_sam(index, batch, OPTS, timers=timers) == want
    assert "map chunks" not in timers.totals


def test_stream_is_the_same_with_tracing_on_and_off(db, small_shapes):
    index, batch = db
    sams = []
    for spans in (False, True):
        timers = StageTimers(spans=spans)
        sams.append(list(tdm.dream_map_stream(index, iter([batch, batch]),
                                              OPTS, timers=timers)))
        assert ("map chunks" in timers.totals) == spans
    assert sams[0] == sams[1]


def test_stages_nest_under_the_profiler(db, small_shapes):
    index, batch = db
    timers = StageTimers(spans=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tdm.dream_map_sam(index, _profiled_batch(batch), OPTS, timers=timers)
    events = prof.events()
    names = {e.name for e in events}
    assert {"ibf classify", "map step enqueue (host)", "device wait+fetch",
            "repetitive re-seed (device)", "sam write (host)"} <= names

    def ancestors(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            yield e.name

    strata = [e for e in events if e.name == "repetitive stratum 1 (enum)"]
    assert strata
    assert all("repetitive re-seed (device)" in ancestors(e) for e in strata)
    assert all("dense re-verify (device)" not in ancestors(e) for e in strata)


def test_spans_off_leave_no_range(db, small_shapes):
    index, batch = db
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tdm.dream_map_sam(index, _profiled_batch(batch), OPTS,
                          timers=StageTimers())
    assert "map step enqueue (host)" not in {e.name for e in prof.events()}


class _Event:
    """A stand-in for torch.cuda.Event: recording reads a clock that the
    test advances."""

    clock_ms = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.t = _Event.clock_ms

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_span_phases_and_total(monkeypatch):
    """Each phase runs from the previous boundary to its mark; the total
    from the start to stop; nothing is added before settle, and a span
    settles once. Off the card, or with `on` false, there is no span."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    timers = StageTimers(spans=True)
    _Event.clock_ms = 10.0
    span = timermod.DeviceSpan(timers, "map step", stream=None)
    for phase, t in (("map seed search", 14.0), ("map locate", 15.5),
                     ("map verify", 18.0)):
        _Event.clock_ms = t
        span.mark(phase)
    _Event.clock_ms = 18.25
    span.stop()
    assert timers.totals == {}
    span.settle()
    span.settle()
    assert timers.totals == pytest.approx({
        "map seed search (device time)": 4e-3, "map locate (device time)": 1.5e-3,
        "map verify (device time)": 2.5e-3, "map step (device time)": 8.25e-3})
    assert timermod.device_span(timers, "x", CPU, True) is timermod.NO_SPAN
    assert timermod.device_span(timers, "x", torch.device("cuda"), False) \
        is timermod.NO_SPAN
    assert timermod.NO_SPAN.mark is None


class _OpCount(TorchDispatchMode):
    """Counts the tensor operations run on this thread while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class _CountingSpan:
    """A device span that logs, at each mark and at its stop, how many
    tensor operations its thread has run since it started."""

    def __init__(self, name, spans):
        self.name, self.log = name, []
        spans.append(self)
        self._ops = _OpCount()
        self._ops.__enter__()

    def mark(self, phase):
        self.log.append((phase, self._ops.n))

    def stop(self):
        self.log.append(("stop", self._ops.n))
        self._ops.__exit__(None, None, None)

    def settle(self):
        pass


def test_no_work_is_queued_after_a_span_s_last_phase(db, small_shapes,
                                                     monkeypatch):
    """A map step's and a repetitive group's phases cover their span: every
    phase queues work, and no operation runs between the last phase's mark
    and the span's end. (On a card the span's end can still follow its
    last mark by the host's time between the two records, where the card
    has caught up with the host; that gap holds no work.)"""
    index, batch = db
    spans = []

    def counting_span(timers, name, device, on):
        return _CountingSpan(name, spans) if on else timermod.NO_SPAN

    monkeypatch.setattr(tmapper, "device_span", counting_span)
    tdm.dream_map_sam(index, batch, OPTS, timers=StageTimers(spans=True))
    phases = {"map step": ["map upload", "map seed search", "map locate",
                           "map verify"],
              "repetitive stratum": ["repetitive upload",
                                     "repetitive seed search",
                                     "repetitive locate", "repetitive verify"]}
    seen = defaultdict(int)
    for span in spans:
        kind = next((k for k in phases if span.name.startswith(k)), None)
        if kind is None:
            assert all(p == "stop" for p, _ in span.log), span.name
            continue
        seen[kind] += 1
        assert [p for p, _ in span.log] == phases[kind] + ["stop"], span.log
        counts = [0] + [n for _, n in span.log]
        assert all(a < b for a, b in zip(counts[:-2], counts[1:-1])), span.log
        assert counts[-1] == counts[-2], (span.name, span.log)
    assert seen["map step"] > 1 and seen["repetitive stratum"] > 1


def test_report_sets_counters_and_device_times_apart():
    timers = StageTimers()
    timers.add("cigar (host)", 0.5)
    timers.add("map step (device time)", 0.25)
    timers.add("map chunks", 3)
    timers.add("map chunks", 4)
    lines = timers.report().splitlines()
    assert lines[0].split()[:2] == ["cigar", "(host)"]
    dev, cnt = lines.index("device time (CUDA events):"), lines.index("counters:")
    assert dev < cnt
    assert "map step (device time)" in lines[dev + 1]
    assert lines[cnt + 1].split() == ["map", "chunks", "7"]
    assert isinstance(timers.totals["map chunks"], int)


def test_mapper_cli_trace_writes_a_chrome_trace(tmp_path, monkeypatch, capsys):
    """--trace FILE: a Chrome trace that names the stages, those of the
    device worker and finisher threads too, nested; -v prints the
    counters."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DY_PLATFORM", "cpu")
    rng = np.random.default_rng(5)
    gs = [rng.integers(0, 4, 4000).astype(np.int8) for _ in range(2)]
    (tmp_path / "fa").mkdir()
    for b, g in enumerate(gs):
        write_fasta(tmp_path / "fa" / f"b{b}.fa", [f"g{b}"], [g])
    indexer.main(["--bins-dir", "fa", "-o", "db"])
    build_filter.main(["--bins-dir", "fa", "-o", "db", "-bs", "4m", "-k", "19"])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open("se.fq", "wb") as fh:
        for i in range(10):
            p = int(rng.integers(0, 3800))
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, acgt[gs[i % 2][p : p + 100]].tobytes(),
                                              b"I" * 100))
    mapper_cli.main(["db", "se.fq", "-o", "out.sam", "-e", "0.03",
                     "--trace", "trace.json", "-v"])
    err = capsys.readouterr().err
    assert "counters:" in err and "routed read-bins" in err
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"] if e.get("ph") == "X"]
    by_name = defaultdict(list)
    for e in events:
        by_name[e["name"]].append(e)
    for name in ("ibf classify", "map step enqueue (host)", "device wait+fetch",
                 "sam write (host)"):
        assert by_name[name], name
    # the enqueue stage holds the map step's operators, on its own thread
    enq = by_name["map step enqueue (host)"][0]
    inside = [e for e in events if e["tid"] == enq["tid"] and e is not enq
              and enq["ts"] <= e["ts"] and e["ts"] + e["dur"] <= enq["ts"] + enq["dur"]]
    assert any(e["name"].startswith("aten::") for e in inside)
    assert (tmp_path / "out.sam").read_bytes().count(b"\n") > 10
