"""Port parity for the config-2 path: DREAM mapping with a blocked canonical
bloom prefilter, single-end and paired-end with mate rescue, against the
JAX package on the same database and reads. Routing masks and matches must
be equal and the SAM byte-identical."""

import numpy as np
import pytest
import torch

from dream_yara_tpu.cli import build_filter, indexer
from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.index.ibf import InterleavedBloomFilter
from dream_yara_tpu.io.fasta import write_fasta
from dream_yara_tpu.io.readstore import ReadBatch
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.pipeline import dis_mapper as jdm
from dream_yara_tpu.pipeline import mapper as jmapper
from dream_yara_tpu.pipeline.matches import dedup_matches, rank_matches
from dream_yara_tpu.utils.alphabet import revcomp
from dream_yara_tpu.utils.options import MapperOptions
from dream_yara_tpu_torch.index.fmindex import FMIndex as TFMIndex
from dream_yara_tpu_torch.index.ibf import InterleavedBloomFilter as TIBF
from dream_yara_tpu_torch.io.seqstore import SeqStore as TSeqStore
from dream_yara_tpu_torch.ops import banded_verify_cuda, row_gather_cuda
from dream_yara_tpu_torch.pipeline import dis_mapper as tdm
from dream_yara_tpu_torch.pipeline import mapper as tmapper
from tests.conftest import mutate, random_text

torch.set_num_threads(2)
CPU = torch.device("cpu")
B = 4
LL, LD = 300, 50
OPTS = MapperOptions(error_rate=0.03, library_length=LL, library_deviation=LD,
                     secondary_matches="tag")


@pytest.fixture(scope="module")
def db():
    """tests/test_dream.py's database: 4 bins of 8,000 bp, a blocked
    canonical 2^22-bit filter; bin 3 has two contigs. Built twice: by the
    reference's host classes (for the JAX side) and by the port's (for the
    port), as (stores, fms, ibf) each."""
    rng = np.random.default_rng(21)
    genomes = [random_text(rng, 8000) for _ in range(B)]
    built = []
    for SeqStore_, FMIndex_, IBF_ in ((SeqStore, FMIndex, InterleavedBloomFilter),
                                      (TSeqStore, TFMIndex, TIBF)):
        stores = [SeqStore_.from_seqs([f"b{b}c0"], [genomes[b]]) for b in range(3)]
        stores.append(SeqStore_.from_seqs(["b3c0", "b3c1"],
                                          [genomes[3][:5000], genomes[3][5000:]]))
        fms = [FMIndex_.build(st.text) for st in stores]
        ibf = IBF_.create(B, size_bits=1 << 22, n_hashes=3, k=19)
        assert ibf.blocked == 1 and ibf.canonical == 1
        for b, g in enumerate(genomes):
            ibf.add_kmers(g, b)
        built.append((stores, fms, ibf))
    np.testing.assert_array_equal(built[1][2].words, built[0][2].words)
    return rng, genomes, built[0], built[1]


def pe_batch(rng, genomes, n_pairs, read_len=100, junk=0.05, tag="p"):
    """FR pairs with 0-3 substitutions per mate, inserts within LL +- LD;
    about `junk` of the mates are random (unmappable), so their partners
    go through mate rescue. Returns the batch and each pair's bin."""
    m1, m2, bins = [], [], []
    for i in range(n_pairs):
        b = int(rng.integers(0, len(genomes)))
        g = genomes[b]
        t = int(rng.integers(LL - LD + 10, LL + LD - 10))
        p = int(rng.integers(0, len(g) - t))
        r1 = mutate(rng, g[p : p + read_len].copy(), n_sub=int(rng.integers(0, 4)))
        r2 = revcomp(mutate(rng, g[p + t - read_len : p + t].copy(),
                            n_sub=int(rng.integers(0, 4))))
        if rng.random() < junk:
            r2 = random_text(rng, read_len)
        if rng.random() < junk:
            r1 = random_text(rng, read_len)
        m1.append(r1)
        m2.append(r2)
        bins.append(b)
    names = [f"{tag}{i}" for i in range(n_pairs)] * 2
    return ReadBatch.from_reads(names, m1 + m2, paired=True), np.array(bins)


def se_batch(rng, genomes, n, read_len=100):
    reads = []
    for i in range(n):
        g = genomes[i % len(genomes)]
        p = int(rng.integers(0, len(g) - read_len))
        r = mutate(rng, g[p : p + read_len].copy(), n_sub=int(rng.integers(0, 4)))
        reads.append(revcomp(r) if i % 2 else r)
    reads.append(random_text(rng, read_len))
    return ReadBatch.from_reads([f"s{i}" for i in range(len(reads))], reads)


def _indexes(db, kind="bloom"):
    (jst, jfms, jibf), (tst, tfms, tibf) = db[2], db[3]
    return (jdm.DreamIndex(jst, jfms, jibf, kind),
            tdm.DreamIndex(tst, tfms, tibf, kind, device=CPU))


def test_classify_reads_equal(db):
    rng, genomes = db[0], db[1]
    batch, bins = pe_batch(rng, genomes, 40, junk=0.0)
    jidx, tidx = _indexes(db)
    want = jdm.classify_reads(jidx, batch, OPTS)
    got = tdm.classify_reads(tidx, batch, OPTS)
    np.testing.assert_array_equal(got, want)
    # the k-mer lemma routes every mate (<= E substitutions) to its bin,
    # and the filter is selective on random genomes
    truth = np.concatenate([bins, bins])
    assert got[np.arange(batch.n_reads), truth].all()
    assert got.sum() <= 2 * batch.n_reads


def test_dream_map_sam_bloom_se_byte_identical(db):
    rng, genomes = db[0], db[1]
    batch = se_batch(rng, genomes, 30)
    jidx, tidx = _indexes(db)
    want = jdm.dream_map_sam(jidx, batch, OPTS, cmdline="parity")
    got = tdm.dream_map_sam(tidx, batch, OPTS, cmdline="parity")
    assert got == want


def test_dream_map_sam_bloom_pe_byte_identical(db):
    """Paired-end with rescue on: SAM bytes and the stats (proper pairs
    included) equal the reference's."""
    rng, genomes = db[0], db[1]
    batch, _ = pe_batch(rng, genomes, 60)
    jidx, tidx = _indexes(db)
    jstats, tstats = {}, {}
    want = jdm.dream_map_sam(jidx, batch, OPTS, cmdline="pe", stats=jstats)
    got = tdm.dream_map_sam(tidx, batch, OPTS, cmdline="pe", stats=tstats)
    assert got == want
    assert tstats == jstats
    assert tstats["proper_pairs"] >= 45
    assert banded_verify_cuda.kernel.launches == 0
    assert row_gather_cuda.kernel.launches == 0


def test_dream_map_stream_bloom_pe_byte_identical(db):
    rng, genomes = db[0], db[1]
    batches = [pe_batch(rng, genomes, 25, tag=f"b{k}")[0] for k in range(2)]
    opts = MapperOptions(error_rate=0.03, library_length=LL,
                         library_deviation=LD, secondary_matches="record")
    jidx, tidx = _indexes(db)
    want = list(jdm.dream_map_stream(jidx, iter(batches), opts))
    got = list(tdm.dream_map_stream(tidx, iter(batches), opts))
    assert len(got) == 2
    assert got == want


def test_rescue_global_equal(db):
    """Mate rescue across bins: with every mate-2 match stripped, the
    rescue re-finds the mates in their bins, as the reference does."""
    rng, genomes = db[0], db[1]
    batch, bins = pe_batch(rng, genomes, 16, junk=0.0)
    jidx, tidx = _indexes(db)
    m = jdm.dis_map_batch(jidx, batch, OPTS)
    h = batch.n_reads // 2
    ranked = rank_matches(dedup_matches(m.take(m.read_id < h)), batch.n_reads)
    want = jdm._rescue_global(jidx, batch, ranked, OPTS, 3, 300)
    got = tdm._rescue_global(tidx, batch, ranked, OPTS, 3, 300)
    for f in ("read_id", "begin", "end", "dist", "strand"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert set(np.unique(got.read_id[got.dist <= 3])) == set(range(h, 2 * h))
    starts = jidx.contigs.bin_starts
    assert all(starts[bins[r - h]] <= b < starts[bins[r - h]] + 8000
               for r, b in zip(got.read_id, got.begin) if r >= h)


def test_map_paired_bin_equal(db):
    """The single-bin PE path: ranked matches, CIGARs, pair info and SAM."""
    rng, genomes, (stores, fms, _), (tst, tfms, _) = db
    batch, _ = pe_batch(rng, genomes[3:], 20, junk=0.1)
    want = jmapper.map_paired_bin(stores[3], fms[3], batch, OPTS)
    got = tmapper.map_paired_bin(tst[3], tfms[3], batch, OPTS, CPU)
    wm, gm = want[0].matches, got[0].matches
    for f in ("read_id", "begin", "end", "dist", "strand"):
        np.testing.assert_array_equal(getattr(gm, f), getattr(wm, f), f)
    np.testing.assert_array_equal(got[0].c1, want[0].c1)
    assert got[1] == want[1]
    for f in ("primary_idx", "proper", "tlen"):
        np.testing.assert_array_equal(getattr(got[3], f), getattr(want[3], f), f)
    want_sam = jmapper.paired_bin_sam(stores[3], fms[3], batch, OPTS, "pe")
    assert tmapper.paired_bin_sam(tst[3], tfms[3], batch, OPTS, CPU,
                                  "pe") == want_sam
    # single_bin_sam dispatches a paired batch to the PE path
    assert tmapper.single_bin_sam(tst[3], tfms[3], batch, OPTS, CPU,
                                  "pe") == want_sam


@pytest.mark.parametrize("filter_type,args", [
    ("bloom", ["-ft", "bloom", "-bs", "4m", "-k", "19"]),
    ("kmer_direct", ["-ft", "kmer_direct", "-k", "10"]),
])
def test_dream_index_load_filters(db, tmp_path, filter_type, args):
    """A database written by the indexer and build-filter tools loads in
    both packages with its prefilter, and maps a PE batch identically."""
    rng, genomes = db[0], db[1]
    for b, g in enumerate(genomes):
        write_fasta(tmp_path / f"bin{b}.fa", [f"g{b}"], [g])
    dbdir = tmp_path / "db"
    fastas = [str(tmp_path / f"bin{b}.fa") for b in range(B)]
    indexer.main([*fastas, "-o", str(dbdir)])
    build_filter.main([*fastas, "-o", str(dbdir), *args])
    jidx = jdm.DreamIndex.load(dbdir, filter_type)
    tidx = tdm.DreamIndex.load(dbdir, filter_type, device=CPU)
    assert tidx.filter_type == filter_type and tidx.filter is not None
    np.testing.assert_array_equal(tidx.filter.words, jidx.filter.words)
    batch, _ = pe_batch(rng, genomes, 12, tag=filter_type)
    np.testing.assert_array_equal(tdm.classify_reads(tidx, batch, OPTS),
                                  jdm.classify_reads(jidx, batch, OPTS))
    assert (tdm.dream_map_sam(tidx, batch, OPTS)
            == jdm.dream_map_sam(jidx, batch, OPTS))
