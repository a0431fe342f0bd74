"""Port parity for the whole config-1 slice: the port's dream_map_sam and
dream_map_stream against the JAX package's on a toy DREAM database (filter
none). The SAM output must be byte-identical, on the default path and on a
tandem-repeat case that spills the verify compaction (dense re-verify) and
overflows seed capacity (the host overflow pass)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dream_yara_tpu.pipeline.mapper as jmapper
from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.io.readstore import ReadBatch
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.pipeline import dis_mapper as jdm
from dream_yara_tpu.utils.alphabet import revcomp
from dream_yara_tpu.utils.options import MapperOptions
from dream_yara_tpu.utils.timer import StageTimers
from dream_yara_tpu_torch.ops import banded_verify_cuda
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
    none, and a present filter file needs the unported prefilter."""
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
    (tmp_path / "db.filter.npz").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 13"):
        tdm.DreamIndex.load(tmp_path, device=CPU)


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
    """Overflowing seeds under sensitivity "high" need the repetitive
    re-seed pass, which is not ported: the port raises, never degrades."""
    store, fm, batch = tandem
    monkeypatch.setattr(tmapper.BinMapper, "DENSE_HALF", 512)
    ids = np.arange(700, 760)
    sub = ReadBatch(names=[batch.names[i] for i in ids],
                    seqs=batch.seqs[np.concatenate([ids, batch.n_reads + ids])],
                    lengths=batch.lengths[ids],
                    quals=[batch.quals[i] for i in ids], paired=False)
    opts = MapperOptions(error_rate=0.03, sensitivity="high")
    index = tdm.DreamIndex([store], [fm], None, "none", device=CPU)
    with pytest.raises(NotImplementedError, match="item 12"):
        tdm.dream_map_sam(index, sub, opts)


def test_unported_paths_raise(db):
    rng, stores, fms = db
    batch = _batch(rng, stores, 4, "p")
    pe = ReadBatch(batch.names, batch.seqs, batch.lengths, batch.quals, True)
    index = tdm.DreamIndex(stores, fms, None, "none", device=CPU)
    with pytest.raises(NotImplementedError, match="item 10"):
        tdm.dream_map_sam(index, pe, MapperOptions())
    bloom = tdm.DreamIndex(stores, fms, object(), "bloom", device=CPU)
    with pytest.raises(NotImplementedError, match="item 13"):
        tdm.dream_map_sam(bloom, batch, MapperOptions())
    with pytest.raises(NotImplementedError, match="item 11"):
        tmapper.BinMapper(stores[0], fms[0].subsample_sa(4), MapperOptions(), CPU)
    assert banded_verify_cuda.kernel.launches == 0   # CPU runs never launch


_NO_JAX = """
import sys
sys.modules["jax"] = None
import numpy as np
import torch
from dream_yara_tpu_torch.pipeline import dis_mapper as dm
from dream_yara_tpu_torch._shared import FMIndex, MapperOptions, ReadBatch, SeqStore
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
print("NO_JAX_OK")
"""


def test_port_imports_and_maps_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout
