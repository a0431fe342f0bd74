"""Port parity for the mesh DREAM path on one device: the port's
MeshDreamMapper against the JAX package's MeshDreamMapper(n_devices=1) —
the step's MeshMapOut arrays, the fallback diagnostics and the SAM, which
must also equal dream_map_sam of both packages byte for byte. The cases
mirror tests/test_parallel.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.index.ibf import InterleavedBloomFilter
from dream_yara_tpu.index.kdx import DirectKmerFilter
from dream_yara_tpu.io.readstore import ReadBatch
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.parallel import dream_mesh as jmesh
from dream_yara_tpu.parallel.dist_mapper import pack_batch_blob
from dream_yara_tpu.pipeline import dis_mapper as jdm
from dream_yara_tpu.pipeline import mapper as jmapper
from dream_yara_tpu.utils.alphabet import revcomp
from dream_yara_tpu.utils.options import MapperOptions
from dream_yara_tpu.utils.timer import StageTimers
from dream_yara_tpu_torch.ops import banded_verify_cuda, row_gather_cuda
from dream_yara_tpu_torch.parallel import dist_mapper as tdist
from dream_yara_tpu_torch.parallel import dream_mesh as tmesh
from dream_yara_tpu_torch.pipeline import dis_mapper as tdm
from dream_yara_tpu_torch.pipeline import mapper as tmapper
from tests.conftest import mutate, random_text

torch.set_num_threads(2)
CPU = torch.device("cpu")
OPTS = MapperOptions(error_rate=0.03)


@pytest.fixture(autouse=True)
def small_repetitive_groups(monkeypatch):
    """Repetitive re-seed groups of 16 rows (rows are independent, so the
    output is the same) keep the CPU runs of both packages short."""
    monkeypatch.setattr(jmapper.BinMapper, "REP_PAD", 16)
    monkeypatch.setattr(tmapper.BinMapper, "REP_PAD", 16)


def _index(genomes, filt=None, kind="none", rate=1):
    stores = [SeqStore.from_seqs([f"g{b}"], [g]) for b, g in enumerate(genomes)]
    fms = [FMIndex.build(st.text, sample_rate=rate) for st in stores]
    return (jdm.DreamIndex(stores, fms, filt, kind),
            tdm.DreamIndex(stores, fms, filt, kind, device=CPU))


def _bloom(genomes, **kw):
    filt = InterleavedBloomFilter.create(len(genomes), size_bits=1 << 22,
                                         n_hashes=3, k=19, **kw)
    for b, g in enumerate(genomes):
        filt.add_kmers(g, b)
    return filt


def _planted(rng, genomes, n_per_bin=6, read_len=100, n_sub=2, tag="b"):
    names, reads, truth = [], [], []
    for b, g in enumerate(genomes):
        for i in range(n_per_bin):
            p = int(rng.integers(0, len(g) - read_len))
            r = mutate(rng, g[p : p + read_len].copy(), n_sub=n_sub)
            strand = int(rng.random() < 0.5)
            names.append(f"{tag}{b}r{i}")
            reads.append(revcomp(r) if strand else r)
            truth.append((b, p, strand))
    return ReadBatch.from_reads(names, reads), truth


def _check(jidx, tidx, batch, opts=OPTS, r_cap=None, lean=False, **mkw):
    """SAM of the port's mesh == JAX mesh (one device) == dream_map_sam of
    both packages; the diagnostics equal. Returns the two mappers."""
    ref = jdm.dream_map_sam(jidx, batch, opts)
    assert tdm.dream_map_sam(tidx, batch, opts) == ref
    jm = jmesh.MeshDreamMapper(jidx, opts, n_devices=1, r_cap=r_cap, lean=lean)
    tm = tmesh.MeshDreamMapper(tidx, opts, r_cap=r_cap, lean=lean, **mkw)
    assert jmesh.mesh_dream_sam(jm, batch) == ref
    assert tmesh.mesh_dream_sam(tm, batch) == ref
    assert tm.fallback_diag == jm.fallback_diag
    assert banded_verify_cuda.kernel.launches == 0
    assert row_gather_cuda.kernel.launches == 0
    return jm, tm


@pytest.fixture(scope="module")
def db_and_reads():
    rng = np.random.default_rng(31)
    genomes = [random_text(rng, 6000) for _ in range(4)]
    jidx, tidx = _index(genomes, _bloom(genomes), "bloom")
    batch, truth = _planted(rng, genomes)
    return genomes, jidx, tidx, batch, truth


def test_mesh_step_out_equals_jax(db_and_reads):
    """One pass of the step: every MeshMapOut array equals the JAX step's
    on the same blob, and the planted sites are found."""
    genomes, jidx, tidx, batch, truth = db_and_reads
    jm = jmesh.MeshDreamMapper(jidx, OPTS, n_devices=1)
    tm = tmesh.MeshDreamMapper(tidx, OPTS)
    n, L = batch.n_reads, batch.max_len
    blob, half = pack_batch_blob(batch.seqs[:n], batch.lengths, 1, L)
    r_cap = tm._r_cap(half)
    assert r_cap == jm._r_cap(half)
    args = (half, L, r_cap, 300, 3, 33, True, 4.0, 1.25)
    want = jm._step(*args)(jm.fmset, jm.filter_words, jnp.asarray(blob))
    out = tm._step(*args)(tm.fmset, tm.filter_words, torch.from_numpy(blob.view(np.int32)))
    got = tdist.fetch_mesh_out(out)()
    for f in tdist.MeshMapOut._fields:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.route_overflow[0, 0]) == 0 and (got.meta < 0).sum() >= n
    m = tm.map_batch(batch)
    found = set(zip(m.read_id.tolist(), m.strand.tolist(), m.begin.tolist()))
    starts = tidx.contigs.bin_starts
    for rid, (b, p, strand) in enumerate(truth):
        assert (rid, strand, int(starts[b]) + p) in found, f"read {rid}"


def test_mesh_sam_and_route_overflow_drains(db_and_reads):
    """The default pool, then r_cap = 1: every pair beyond the pool drains
    through override passes, the rest re-maps on the exact path."""
    genomes, jidx, tidx, batch, truth = db_and_reads
    _check(jidx, tidx, batch)
    timers = StageTimers()
    jm, tm = _check(jidx, tidx, batch, r_cap=1)
    assert tm.fallback_diag["route_ovf"] > 0
    assert tm.fallback_diag["drain_passes"] == tm.MAX_DRAIN
    assert tmesh.mesh_dream_sam(tm, batch, timers=timers) == \
        jdm.dream_map_sam(jidx, batch, OPTS)
    assert timers.totals["mesh overflow fallback (host)"] > 0


def test_mesh_skewed_routing_drain_and_autotune():
    """Config-5's shape: a hot family of identical bins takes 90 % of the
    reads, so routed pairs exceed the default pool; they drain through
    override passes, the pool grows for the next batch, which drains less,
    and both SAMs equal the single-device ones."""
    rng = np.random.default_rng(41)
    hot = random_text(rng, 3000)
    genomes = [hot.copy() for _ in range(4)] + [random_text(rng, 3000)
                                                 for _ in range(4)]
    jidx, tidx = _index(genomes, _bloom(genomes), "bloom")

    def make_batch(seed, n=256):
        r = np.random.default_rng(seed)
        reads = []
        for i in range(n):
            b = 0 if i % 10 < 9 else int(r.integers(4, 8))
            p = int(r.integers(0, 2900))
            reads.append(mutate(r, genomes[b][p : p + 100].copy(), n_sub=1))
        return ReadBatch.from_reads([f"s{seed}r{i}" for i in range(n)], reads)

    b1, b2 = make_batch(1), make_batch(2)
    jm = jmesh.MeshDreamMapper(jidx, OPTS, n_devices=1)
    tm = tmesh.MeshDreamMapper(tidx, OPTS)
    for batch in (b1, b2):
        ref = jdm.dream_map_sam(jidx, batch, OPTS)
        assert jmesh.mesh_dream_sam(jm, batch) == ref
        assert tmesh.mesh_dream_sam(tm, batch) == ref
        assert tm.fallback_diag == jm.fallback_diag
        if batch is b1:
            d1 = tm.fallback_diag["drain_passes"]
            assert d1 >= 2 and tm._tuned_r_cap == jm._tuned_r_cap > 0
    assert 0 < tm.fallback_diag["drain_passes"] - d1 < d1


@pytest.mark.parametrize("sens", ["full", "high", "low"])
def test_mesh_seed_overflow_fallback(sens):
    """A tandem bin overflows every seed's hit capacity; the per-pair
    fallback (and at sensitivity full the verify spill) converge to the
    single-device output."""
    rng = np.random.default_rng(77)
    unit = random_text(rng, 40)
    plain = random_text(rng, 2400)
    jidx, tidx = _index([np.tile(unit, 60), plain])
    batch = ReadBatch.from_reads(["rep", "plain"],
                                 [np.tile(unit, 3)[:80].copy(), plain[100:180].copy()])
    opts = MapperOptions(error_rate=0.03, sensitivity=sens)
    jm, tm = _check(jidx, tidx, batch, opts)
    d = tm.fallback_diag
    if sens == "full":
        assert d["spill_bins"] > 0
    if sens != "low":
        assert d["spill_bins"] + d["seed_ovf"] > 0


@pytest.mark.parametrize("lean", [False, True])
def test_mesh_sampled_sa_loc_cap_spill(monkeypatch, lean):
    """A rate-4 SA, with a locate budget (DY_CAP2L) too small for a tandem
    bin's hits: dropped lanes go to the per-pair fallback on a view of the
    (lean) stacked set, whose locate walks the fused rows."""
    rng = np.random.default_rng(15)
    unit = random_text(rng, 60)
    genomes = [np.concatenate([unit] * 40 + [random_text(rng, 2000)]),
               random_text(rng, 4000)]
    jidx, tidx = _index(genomes, rate=4)
    batch, _ = _planted(rng, genomes)
    monkeypatch.setenv("DY_CAP2L", "0.02")
    jm, tm = _check(jidx, tidx, batch, lean=lean)
    assert tm.fallback_diag["seed_ovf"] > 0
    if lean:
        assert tm.fmset.bwt_blocks.shape[1] == 1


def test_mesh_kmer_direct_and_minimizer(db_and_reads):
    """The kdx prefilter (direct addressing) and a calibrated minimizer
    bloom filter route through the step's classify as the single-device
    classifier does."""
    genomes, jidx, tidx, batch, truth = db_and_reads
    kdx = DirectKmerFilter.create(4, k=12)
    for b, g in enumerate(genomes):
        kdx.add_kmers(g, b)
    jk, tk = (jdm.DreamIndex(jidx.stores, jidx.fms, kdx, "kmer_direct"),
              tdm.DreamIndex(tidx.stores, tidx.fms, kdx, "kmer_direct", device=CPU))
    jm, tm = _check(jk, tk, batch)
    assert tm.use_filter and tm.direct
    mini = _bloom(genomes, window=27)
    mini.calibrate(e_max=4, trials=200, read_lens=(100,))
    _check(jdm.DreamIndex(jidx.stores, jidx.fms, mini, "bloom"),
           tdm.DreamIndex(tidx.stores, tidx.fms, mini, "bloom", device=CPU), batch)


def test_mesh_pe_and_no_filter(db_and_reads):
    """Paired-end with mate rescue (one mate random), and filter none
    (every read to every bin)."""
    genomes, jidx, tidx, batch_se, truth = db_and_reads
    rng = np.random.default_rng(5)
    m1, m2 = [], []
    for b, g in enumerate(genomes):
        for i in range(3):
            p = int(rng.integers(0, len(g) - 400))
            m1.append(mutate(rng, g[p : p + 100].copy(), n_sub=1))
            m2.append(random_text(rng, 100) if b == i == 0 else
                      revcomp(mutate(rng, g[p + 200 : p + 300].copy(), n_sub=1)))
    batch = ReadBatch.from_reads([f"p{i}" for i in range(len(m1))] * 2, m1 + m2,
                                 paired=True)
    opts = MapperOptions(error_rate=0.03, library_length=300, library_deviation=60)
    _check(jidx, tidx, batch, opts)
    _check(jdm.DreamIndex(jidx.stores, jidx.fms, None, "none"),
           tdm.DreamIndex(tidx.stores, tidx.fms, None, "none", device=CPU),
           batch_se)


def test_mesh_stream_matches_per_batch(db_and_reads):
    """mesh_dream_stream yields the per-batch SAMs, headers and stats
    included, and equals the JAX stream."""
    genomes, jidx, tidx, batch, truth = db_and_reads
    b2, _ = _planted(np.random.default_rng(77), genomes, n_per_bin=4, tag="c")
    opts = MapperOptions(error_rate=0.03, secondary_matches="tag")
    tm = tmesh.MeshDreamMapper(tidx, opts)
    stats_ref: dict = {}
    ref = [tmesh.mesh_dream_sam(tm, batch, header=True, stats=stats_ref),
           tmesh.mesh_dream_sam(tm, b2, header=False, stats=stats_ref)]
    stats: dict = {}
    assert list(tmesh.mesh_dream_stream(tm, [batch, b2], stats=stats)) == ref
    assert stats == stats_ref
    jm = jmesh.MeshDreamMapper(jidx, opts, n_devices=1)
    assert list(jmesh.mesh_dream_stream(jm, [batch, b2])) == ref
    assert list(tmesh.mesh_dream_stream(tm, [b2], header=False)) == ref[1:]


@pytest.fixture(scope="module")
def cassette_db():
    """tests/test_parallel.py's cassette database: reads co-optimal in every
    bin, and planted 1-error copies visible at -s 1."""
    rng = np.random.default_rng(97)
    cassette = random_text(rng, 400)
    genomes = []
    for b in range(4):
        g = random_text(rng, 6000)
        g[1000 + 37 * b : 1400 + 37 * b] = cassette
        genomes.append(g)
    names, reads = [], []
    for i in range(6):
        r = genomes[0][1000 + 30 * i : 1100 + 30 * i].copy()
        r = mutate(rng, r, n_sub=1) if i % 2 else r
        names.append(f"cas{i}")
        reads.append(revcomp(r) if i % 3 == 0 else r)
    for i in range(4):
        p = 1600 + 120 * i
        seg = genomes[0][p : p + 100].copy()
        sub = seg.copy()
        sub[50] = (sub[50] + 1) % 4
        genomes[2][p : p + 100] = sub
        names.append(f"sub{i}")
        reads.append(seg)
    jidx, tidx = _index(genomes, _bloom(genomes), "bloom")
    return jidx, tidx, ReadBatch.from_reads(names, reads)


@pytest.mark.parametrize("sm,s", [("tag", 0), ("record", 1), ("omit", 1)])
def test_mesh_option_matrix(cassette_db, sm, s):
    jidx, tidx, batch = cassette_db
    _check(jidx, tidx, batch, MapperOptions(error_rate=0.03, strata_count=s,
                                            secondary_matches=sm))


def test_mesh_cap_autotune_and_refusals(db_and_reads, monkeypatch):
    """The cap tuner shrinks the locate and verify caps to the observed
    demand after a batch, never above the defaults, as the reference's; an
    env knob pins its cap. More than one device, or another device than
    the index's, is refused."""
    monkeypatch.delenv("DY_CAP2L", raising=False)
    monkeypatch.delenv("DY_CAP2V", raising=False)
    genomes, jidx, tidx, batch, truth = db_and_reads
    j8, t8 = _index(genomes, rate=4)
    jm, tm = _check(j8, t8, batch, lean=True)
    assert tm._caps() == jm._caps()
    assert tm._caps()[0] < 4.0 and tm._caps()[1] <= 1.25
    assert tm._seen_loc_f == jm._seen_loc_f > 0
    monkeypatch.setenv("DY_CAP2L", "3.5")
    assert tm._caps()[0] == 3.5
    monkeypatch.setenv("DY_TUNE_CAPS", "0")
    assert tm._caps() == (3.5, 1.25)
    with pytest.raises(NotImplementedError, match="item 16"):
        tmesh.MeshDreamMapper(tidx, OPTS, n_devices=2)
    with pytest.raises(ValueError, match="differs"):
        tmesh.MeshDreamMapper(tidx, OPTS, device=torch.device("meta"))
