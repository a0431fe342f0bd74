"""Port parity for the whole config-1 slice: the port's dream_map_sam and
dream_map_stream against the JAX package's on a toy DREAM database (filter
none). The SAM output must be byte-identical, on the default path, on a
tandem-repeat case that spills the verify compaction (dense re-verify) and
overflows seed capacity (the host overflow pass at sensitivity full, the
repetitive strata at high), and on a sampled SA."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dream_yara_tpu.pipeline.mapper as jmapper
from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.index.ibf import InterleavedBloomFilter
from dream_yara_tpu.io.readstore import ReadBatch
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.pipeline import dis_mapper as jdm
from dream_yara_tpu.utils.alphabet import revcomp
from dream_yara_tpu.utils.options import MapperOptions
from dream_yara_tpu.utils.timer import StageTimers
from dream_yara_tpu_torch.ops import banded_verify_cuda, row_gather_cuda
from dream_yara_tpu_torch.pipeline import dis_mapper as tdm
from dream_yara_tpu_torch.pipeline import mapper as tmapper
from tests.conftest import mutate, random_text

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent


def _planted(rng, text, n, read_len=100, max_sub=3):
    reads = []
    for i in range(n):
        while True:
            p = int(rng.integers(0, len(text) - read_len))
            w = text[p : p + read_len]
            if (w < 4).all():
                break
        r = mutate(rng, w.copy(), n_sub=int(rng.integers(0, max_sub + 1)))
        reads.append(revcomp(r) if i % 2 else r)
    return reads


@pytest.fixture(scope="module")
def db():
    """Two bins, three contigs, a duplicated segment (multi-mapping reads)."""
    rng = np.random.default_rng(2024)
    seg = random_text(rng, 600)
    g0 = np.concatenate([random_text(rng, 3000), seg, random_text(rng, 2000)])
    g1 = random_text(rng, 4000)
    g2 = np.concatenate([random_text(rng, 1500), seg, random_text(rng, 1500)])
    stores = [SeqStore.from_seqs(["b0c0", "b0c1"], [g0[:2500], g0[2500:]]),
              SeqStore.from_seqs(["b1c0"], [np.concatenate([g1, g2])])]
    fms = [FMIndex.build(st.text) for st in stores]
    return rng, stores, fms


def _batch(rng, stores, n, tag):
    reads = []
    for st in stores:
        reads += _planted(rng, st.text, n // 2)
    reads += [random_text(rng, 100)]                       # unmappable
    return ReadBatch.from_reads([f"{tag}r{i}" for i in range(len(reads))], reads)


def test_dream_map_sam_byte_identical(db):
    rng, stores, fms = db
    batch = _batch(rng, stores, 40, "s")
    opts = MapperOptions(error_rate=0.03, secondary_matches="tag")
    want = jdm.dream_map_sam(jdm.DreamIndex(stores, fms, None, "none"), batch,
                             opts, cmdline="parity")
    index = tdm.DreamIndex(stores, fms, None, "none", device=CPU)
    stats = {}
    got = tdm.dream_map_sam(index, batch, opts, cmdline="parity", stats=stats)
    assert got == want
    assert stats["reads"] == batch.n_reads and stats["mapped"] >= 30


def test_dream_map_stream_byte_identical(db):
    """Three batches through the stream with the finisher pool on;
    the last batch has mixed read lengths (the gather path)."""
    rng, stores, fms = db
    batches = [_batch(rng, stores, 30, f"b{k}") for k in range(2)]
    mixed = _planted(rng, stores[1].text, 12, read_len=90)
    mixed += _planted(rng, stores[0].text, 12, read_len=100)
    batches.append(ReadBatch.from_reads([f"m{i}" for i in range(24)], mixed))
    opts = MapperOptions(error_rate=0.03, secondary_matches="record")
    want = list(jdm.dream_map_stream(jdm.DreamIndex(stores, fms, None, "none"),
                                     iter(batches), opts))
    index = tdm.DreamIndex(stores, fms, None, "none", device=CPU)
    got = list(tdm.dream_map_stream(index, iter(batches), opts))
    assert len(got) == 3
    assert got == want


def test_dream_index_load_byte_identical(db, tmp_path):
    """A database directory (the indexer's layout) loads in both packages;
    without a filter file the default "bloom" request maps with filter
    none, and with one it routes through the prefilter."""
    rng, stores, fms = db
    (tmp_path / "bins").mkdir()
    for b, (st, fm) in enumerate(zip(stores, fms)):
        st.save(jdm.bin_file(tmp_path, b, "store"))
        fm.save(jdm.bin_file(tmp_path, b, "fm"))
    (tmp_path / "meta.json").write_text('{"n_bins": 2}')
    batch = _batch(rng, stores, 10, "l")
    opts = MapperOptions(error_rate=0.03)
    want = jdm.dream_map_sam(jdm.DreamIndex.load(tmp_path), batch, opts)
    assert tdm.dream_map_sam(tdm.DreamIndex.load(tmp_path, device=CPU),
                             batch, opts) == want
    ibf = InterleavedBloomFilter.create(2, size_bits=1 << 22, n_hashes=3, k=19)
    for b, st in enumerate(stores):
        ibf.add_kmers(st.text, b)
    ibf.save(tmp_path / "db.filter")
    index = tdm.DreamIndex.load(tmp_path, device=CPU)
    assert index.filter_type == "bloom" and index.filter.blocked == 1
    assert tdm.dream_map_sam(index, batch, opts) == jdm.dream_map_sam(
        jdm.DreamIndex.load(tmp_path), batch, opts)


@pytest.fixture(scope="module")
def tandem():
    """tests/test_pipeline_se.py's spill case: reads inside a 50-unit
    tandem repeat overflow the seed capacity and the verify compaction."""
    rng = np.random.default_rng(123)
    unit = rng.integers(0, 4, 50).astype(np.int8)
    genome = np.concatenate([np.tile(unit, 50),
                             rng.integers(0, 4, 3000).astype(np.int8)])
    store = SeqStore.from_seqs(["tand"], [genome])
    fm = FMIndex.build(store.text)
    reads = [np.tile(unit, 3)[:100].copy() for _ in range(700)]
    reads += [genome[i * 3 : i * 3 + 100].copy() for i in range(300)]
    batch = ReadBatch.from_reads([f"r{i}" for i in range(len(reads))], reads)
    return store, fm, batch


def test_spill_and_overflow_byte_identical(tandem, monkeypatch):
    """Small dense sub-chunks keep the CPU run short; the output does not
    depend on them (tests/test_pipeline_se.py::test_dense_reverify_subchunks)."""
    store, fm, batch = tandem
    monkeypatch.setattr(jmapper.BinMapper, "DENSE_HALF", 512)
    monkeypatch.setattr(tmapper.BinMapper, "DENSE_HALF", 512)
    opts = MapperOptions(error_rate=0.03, sensitivity="full")
    want = jdm.dream_map_sam(jdm.DreamIndex([store], [fm], None, "none"),
                             batch, opts)
    timers = StageTimers()
    index = tdm.DreamIndex([store], [fm], None, "none", device=CPU)
    got = tdm.dream_map_sam(index, batch, opts, timers=timers)
    assert timers.totals.get("dense re-verify (device)", 0) > 0
    assert timers.totals.get("overflow fallback", 0) > 0
    assert got == want


def test_repetitive_pass_raises_not_implemented(tandem, monkeypatch):
    """Overflowing seeds under sensitivity "high" (the default) take the
    repetitive re-seed strata: the SAM is byte-identical to the JAX
    package's (the name dates from before the strata were ported)."""
    store, fm, batch = tandem
    monkeypatch.setattr(jmapper.BinMapper, "DENSE_HALF", 512)
    monkeypatch.setattr(tmapper.BinMapper, "DENSE_HALF", 512)
    monkeypatch.setattr(jmapper.BinMapper, "REP_PAD", 64)
    monkeypatch.setattr(tmapper.BinMapper, "REP_PAD", 64)
    ids = np.concatenate([np.arange(700, 740), np.arange(0, 20)])
    sub = ReadBatch(names=[batch.names[i] for i in ids],
                    seqs=batch.seqs[np.concatenate([ids, batch.n_reads + ids])],
                    lengths=batch.lengths[ids],
                    quals=[batch.quals[i] for i in ids], paired=False)
    opts = MapperOptions(error_rate=0.03, sensitivity="high")
    want = jdm.dream_map_sam(jdm.DreamIndex([store], [fm], None, "none"),
                             sub, opts)
    timers = StageTimers()
    index = tdm.DreamIndex([store], [fm], None, "none", device=CPU)
    assert tdm.dream_map_sam(index, sub, opts, timers=timers) == want
    assert timers.totals.get("repetitive re-seed (device)", 0) > 0


def test_unported_paths_raise(db, tandem, monkeypatch):
    """A sampled SA (rate 4) maps to the same SAM bytes as the JAX package
    on the same index, on the default path and through the host overflow
    pass's sampled locate (the name dates from before the sampled SA was
    ported); CPU runs never launch a kernel."""
    rng, stores, fms = db
    batch = _batch(rng, stores, 20, "q")
    opts = MapperOptions(error_rate=0.03, sensitivity="full")
    fms4 = [fm.subsample_sa(4) for fm in fms]
    want = jdm.dream_map_sam(jdm.DreamIndex(stores, fms4, None, "none"),
                             batch, opts)
    index = tdm.DreamIndex(stores, fms4, None, "none", device=CPU)
    assert tdm.dream_map_sam(index, batch, opts) == want
    assert want == jdm.dream_map_sam(jdm.DreamIndex(stores, fms, None, "none"),
                                     batch, opts)
    store, fm, tbatch = tandem
    monkeypatch.setattr(jmapper.BinMapper, "DENSE_HALF", 512)
    monkeypatch.setattr(tmapper.BinMapper, "DENSE_HALF", 512)
    ids = np.arange(680, 740)
    sub = ReadBatch(names=[tbatch.names[i] for i in ids],
                    seqs=tbatch.seqs[np.concatenate([ids, tbatch.n_reads + ids])],
                    lengths=tbatch.lengths[ids],
                    quals=[tbatch.quals[i] for i in ids], paired=False)
    timers = StageTimers()
    index = tdm.DreamIndex([store], [fm.subsample_sa(4)], None, "none",
                           device=CPU)
    got = tdm.dream_map_sam(index, sub, opts, timers=timers)
    assert timers.totals.get("overflow fallback", 0) > 0
    assert got == jdm.dream_map_sam(jdm.DreamIndex([store], [fm], None, "none"),
                                    sub, opts)
    assert banded_verify_cuda.kernel.launches == 0
    assert row_gather_cuda.kernel.launches == 0


_NO_JAX = """
import sys
sys.modules["jax"] = None
import numpy as np
import torch
from dream_yara_tpu_torch.pipeline import dis_mapper as dm
from dream_yara_tpu_torch._shared import (FMIndex, InterleavedBloomFilter,
                                          MapperOptions, ReadBatch, SeqStore,
                                          revcomp)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
rng = np.random.default_rng(5)
g = rng.integers(0, 4, 3000).astype(np.int8)
store = SeqStore.from_seqs(["c"], [g])
index = dm.DreamIndex([store], [FMIndex.build(store.text)], None, "none",
                      device=torch.device("cpu"))
batch = ReadBatch.from_reads(["a", "b"], [g[100:200].copy(), g[900:1000].copy()])
sam = dm.dream_map_sam(index, batch, MapperOptions(error_rate=0.03)).decode()
recs = [l.split("\\t") for l in sam.splitlines() if not l.startswith("@")]
assert [r[3] for r in recs] == ["101", "901"], recs
# a paired-end batch routed by a blocked bloom filter over two bins
g2 = rng.integers(0, 4, 3000).astype(np.int8)
stores = [store, SeqStore.from_seqs(["d"], [g2])]
ibf = InterleavedBloomFilter.create(2, size_bits=1 << 22, n_hashes=3, k=19)
for b, s in enumerate((g, g2)):
    ibf.add_kmers(s, b)
index = dm.DreamIndex(stores, [FMIndex.build(st.text) for st in stores], ibf,
                      "bloom", device=torch.device("cpu"))
mates = [g2[500:600].copy(), revcomp(g2[700:800].copy())]
pe = ReadBatch.from_reads(["p", "p"], mates, paired=True)
opts = MapperOptions(error_rate=0.03, library_length=300, library_deviation=50)
assert dm.classify_reads(index, pe, opts).tolist() == [[False, True]] * 2
sam = dm.dream_map_sam(index, pe, opts).decode()
recs = [l.split("\\t") for l in sam.splitlines() if not l.startswith("@")]
assert [(r[2], r[3], int(r[1]) & 0x2) for r in recs] == [
    ("d", "501", 2), ("d", "701", 2)], recs
# a repeated segment on a rate-4 sampled SA with a bidirectional sidecar:
# the read's exact seeds overflow, so sensitivity high re-seeds it
from dream_yara_tpu_torch._shared import StageTimers, build_reverse_fused
from dream_yara_tpu_torch.pipeline.mapper import BinMapper
BinMapper.REP_PAD = 16          # small groups keep the CPU run short
seg = rng.integers(0, 4, 300).astype(np.int8)
store = SeqStore.from_seqs(["t"], [np.concatenate([np.tile(seg, 20), g])])
read = seg[50:150].copy()
read[50] = (read[50] + 1) % 4
index = dm.DreamIndex([store], [FMIndex.build(store.text, sample_rate=4)],
                      None, "none", device=torch.device("cpu"),
                      rfused={0: build_reverse_fused(store.text)[0]})
timers = StageTimers()
sam = dm.dream_map_sam(index, ReadBatch.from_reads(["t"], [read]),
                       MapperOptions(error_rate=0.03), timers=timers).decode()
recs = [l.split("\t") for l in sam.splitlines() if not l.startswith("@")]
assert (int(recs[0][3]) - 51) % 300 == 0 and recs[0][5] == "100M", recs
assert timers.totals["repetitive re-seed (device)"] > 0, timers.totals
assert "dream_yara_tpu.ops.rank" not in sys.modules
print("NO_JAX_OK")
"""


def test_port_imports_and_maps_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout
