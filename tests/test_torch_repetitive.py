"""Port parity for the repetitive re-seed strata: one group through
repetitive_map_step with each backend, the backend choice, the sidecar
loading of DreamIndex, and the SAM of a small repeat-rich DREAM database at
sensitivity high, each against the JAX package on the same inputs (exact
equality; SAM byte-identical).

On a sampled SA the port's strata locate their hits by the LF walk, so they
give the JAX package's FULL-SA output. The reference expands them with a
plain gather of the sampled values (dream_yara_tpu/pipeline/map_step.py,
repetitive_map_step), which loses them; test_sampled_strata_give_full_sa_output
pins that fault (ROADMAP Queue 3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dream_yara_tpu.pipeline.mapper as jmapper
from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.index.ibf import InterleavedBloomFilter
from dream_yara_tpu.io.readstore import ReadBatch
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.ops.device_index import DeviceFM as JDeviceFM
from dream_yara_tpu.pipeline import dis_mapper as jdm
from dream_yara_tpu.pipeline import map_step as jms
from dream_yara_tpu.utils.options import MapperOptions
from dream_yara_tpu.utils.simulate import repeat_rich_genome, sample_reads
from dream_yara_tpu.utils.timer import StageTimers
from dream_yara_tpu_torch._shared import build_reverse_fused
from dream_yara_tpu_torch.ops.device_index import DeviceFM
from dream_yara_tpu_torch.pipeline import dis_mapper as tdm
from dream_yara_tpu_torch.pipeline import map_step as tms
from dream_yara_tpu_torch.pipeline import mapper as tmapper
from tests.test_classifier import tandem_case

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


@pytest.fixture(scope="module")
def rich():
    """One 60 kbp repeat-rich bin, its reverse rows, and 40 reads (half from
    repeat copies) as a (fwd | revcomp) row matrix; read 3 is 90 bp."""
    rng = np.random.default_rng(3)
    g, ann = repeat_rich_genome(rng, 60_000, alu_count=40, tandem_loci=3,
                                n_runs=2)
    store = SeqStore.from_seqs(["g"], [g])
    fm = FMIndex.build(store.text)
    rfused, _ = build_reverse_fused(store.text)
    reads, _ = sample_reads(rng, g, 40, regions=ann["alu"] + ann["tandem"])
    R = np.stack(reads).astype(np.int8)
    rows = np.concatenate([R, R[:, ::-1]])
    lens = np.full(40, 100, np.int32)
    lens[3] = 90
    rows[[3, 43], 90:] = 4
    return store, fm, rfused, rows, lens


@pytest.mark.parametrize("budget,indels,backend,m", [
    (1, True, "enum", 32), (2, False, "enum", 16),
    (1, False, "bidir", 32), (2, False, "bidir", 16)])
def test_repetitive_map_step_equals_jax(rich, budget, indels, backend, m):
    """A 16-row group (two rows masked, one ragged) with each backend; the
    port at sample rate 4 gives the same output as on the full SA."""
    store, fm, rfused, reads, lens = rich
    rep_rows = np.arange(0, 80, 5, dtype=np.int32)
    mask = np.ones(16, bool)
    mask[-2:] = False
    kw = dict(rate_ppm=300, max_errors=3, capacity=4, max_slen_rep=m,
              verify_capacity=8, budget=budget, indels=indels, backend=backend)
    want = jms.repetitive_map_step(
        JDeviceFM.from_host(fm, store.text, rfused=rfused), jnp.asarray(reads),
        jnp.asarray(lens), jnp.asarray(rep_rows), jnp.asarray(mask), **kw)
    args = (torch.from_numpy(reads), torch.from_numpy(lens),
            torch.from_numpy(rep_rows), torch.from_numpy(mask))
    got = tms.repetitive_map_step(
        DeviceFM.from_host(fm, store.text, CPU, rfused=rfused), *args, **kw)
    got4 = tms.repetitive_map_step(
        DeviceFM.from_host(fm.subsample_sa(4), store.text, CPU, rfused=rfused),
        *args, sample_rate=4, **kw)
    for g, g4, w, name in zip(got, got4, want,
                              ["row", "begin", "end", "dist", "ok", "n_spilled"]):
        _eq(g, w, name)
        _eq(g4, w, f"{name} (sample rate 4)")
    assert int(got[4].sum()) > 0


def test_sampled_strata_give_full_sa_output():
    """The tandem read of tests/test_classifier.py (a 300 bp segment x 20,
    one substitution): budget 1 with indels, capacity 4. The reference
    finds 8 lanes at 4850/5150/5450/5750 on the full SA and none on its
    rate-4 index; the port finds the 8 on both."""
    store, fm, batch, _ = tandem_case(np.random.default_rng(0))
    rows, mask = np.zeros(1, np.int32), np.ones(1, bool)
    kw = dict(rate_ppm=300, max_errors=3, capacity=4, max_slen_rep=32,
              budget=1, indels=True)

    def jax_step(f):
        return jms.repetitive_map_step(
            JDeviceFM.from_host(f, store.text), jnp.asarray(batch.seqs),
            jnp.asarray(batch.lengths), jnp.asarray(rows), jnp.asarray(mask),
            **kw)

    def port_step(f):
        return tms.repetitive_map_step(
            DeviceFM.from_host(f, store.text, CPU),
            torch.from_numpy(batch.seqs), torch.from_numpy(batch.lengths),
            torch.from_numpy(rows), torch.from_numpy(mask),
            sample_rate=f.sample_rate, **kw)

    fm4 = fm.subsample_sa(4)
    want = jax_step(fm)
    ok = np.asarray(want[4])
    assert sorted(set(np.asarray(want[1])[ok].tolist())) == [4850, 5150, 5450, 5750]
    for got in (port_step(fm), port_step(fm4)):
        for g, w in zip(got, want):
            _eq(g, w)
    assert int(np.asarray(jax_step(fm4)[4]).sum()) == 0   # the reference fault


def test_seed_backend_equals_jax(rich, monkeypatch):
    """Every decision input: the sidecar, indels, ragged windows, no rows,
    opts.seed_backend and DY_SEED_BACKEND."""
    store, fm, rfused, _, _ = rich
    lens = np.array([100, 100, 90, 100], np.int32)
    cases = []
    for env in (None, "enum", "bidir", "auto"):
        for opt in ("auto", "enum"):
            for rows in (np.array([0, 1, 3]), np.array([0, 2]),
                         np.zeros(0, np.int32)):
                for budget, indels, t_max in ((1, False, 32), (1, True, 32),
                                              (2, False, 16), (1, False, 48)):
                    cases.append((env, opt, rows, budget, indels, t_max))
    for rf in (rfused, None):
        jbm = jmapper.BinMapper(store, fm, MapperOptions(), rfused=rf)
        tbm = tmapper.BinMapper(store, fm, MapperOptions(), CPU, rfused=rf)
        seen = set()
        for env, opt, rows, budget, indels, t_max in cases:
            if env is None:
                monkeypatch.delenv("DY_SEED_BACKEND", raising=False)
            else:
                monkeypatch.setenv("DY_SEED_BACKEND", env)
            jbm.opts = tbm.opts = MapperOptions(seed_backend=opt)
            args = (rows, lens, 300, budget, indels, t_max)
            got = tbm._seed_backend(*args)
            assert got == jbm._seed_backend(*args), (env, opt, rows, budget)
            seen.add(got)
        assert seen == ({"enum", "bidir"} if rf is not None else {"enum"})


def test_dream_index_load_sidecars(rich, tmp_path, capsys):
    """A fresh `.rfm` sidecar loads, a stale one (another text's rows) is
    ignored with a message, as in the reference."""
    store, fm, rfused, _, _ = rich
    other = SeqStore.from_seqs(["o"], [store.text[:30_000] % 4])
    stores, fms = [store, other], [fm, FMIndex.build(other.text)]
    (tmp_path / "bins").mkdir()
    for b, (st, f) in enumerate(zip(stores, fms)):
        st.save(jdm.bin_file(tmp_path, b, "store"))
        f.save(jdm.bin_file(tmp_path, b, "fm"))
        np.savez(jdm.bin_file(tmp_path, b, "rfm"), rfused=rfused)
    (tmp_path / "meta.json").write_text('{"n_bins": 2}')
    want = jdm.DreamIndex.load(tmp_path)
    assert "stale bidir sidecar" in capsys.readouterr().err
    got = tdm.DreamIndex.load(tmp_path, device=CPU)
    assert "stale bidir sidecar" in capsys.readouterr().err
    assert sorted(got.rfused) == sorted(want.rfused) == [0]
    np.testing.assert_array_equal(got.rfused[0], want.rfused[0])
    bm = got.bin_mapper(0, MapperOptions())
    _eq(bm.dev.rfused, rfused)
    assert got.bin_mapper(1, MapperOptions()).dev.rfused is None


@pytest.fixture(scope="module")
def rich_db():
    """tests/test_repeat_rich.py's database (3 x 60 kbp repeat-rich bins, a
    blocked bloom filter) with each bin's reverse rows, and 60 reads, half
    from repeat copies."""
    rng = np.random.default_rng(2027)
    genomes, anns = [], []
    for _ in range(3):
        g, ann = repeat_rich_genome(rng, 60_000, alu_count=20, tandem_loci=2,
                                    n_runs=2)
        genomes.append(g)
        anns.append(ann)
    stores = [SeqStore.from_seqs([f"g{b}"], [g]) for b, g in enumerate(genomes)]
    fms = [FMIndex.build(st.text) for st in stores]
    rfused = {b: build_reverse_fused(st.text)[0] for b, st in enumerate(stores)}
    filt = InterleavedBloomFilter.create(3, size_bits=1 << 23, n_hashes=3, k=19)
    for b, g in enumerate(genomes):
        filt.add_kmers(g, b)
    names, reads = [], []
    rng = np.random.default_rng(11)
    for b, g in enumerate(genomes):
        rs, _ = sample_reads(rng, g, 20, regions=anns[b]["alu"] + anns[b]["tandem"])
        reads += rs
        names += [f"b{b}r{i}" for i in range(len(rs))]
    return stores, fms, rfused, filt, ReadBatch.from_reads(names, reads)


@pytest.mark.parametrize("sidecar,indels", [(False, True), (True, True),
                                            (True, False)])
def test_sam_high_repeat_rich_byte_identical(rich_db, sidecar, indels,
                                             monkeypatch):
    """Sensitivity high (the default) with its repetitive strata: the port
    on the full SA and on a rate-4 sampled SA gives the JAX package's
    full-SA SAM bytes, with and without the bidirectional sidecars; with
    indels off the sidecar puts stratum 1 on the bidir backend."""
    stores, fms, rfused, filt, batch = rich_db
    monkeypatch.setattr(jmapper.BinMapper, "REP_PAD", 64)
    monkeypatch.setattr(tmapper.BinMapper, "REP_PAD", 64)
    monkeypatch.delenv("DY_SEED_BACKEND", raising=False)
    rf = rfused if sidecar else None
    opts = MapperOptions(error_rate=0.03, indels=indels)
    want = jdm.dream_map_sam(jdm.DreamIndex(stores, fms, filt, "bloom",
                                            rfused=rf), batch, opts)
    for f in (fms, [fm.subsample_sa(4) for fm in fms]):
        timers = StageTimers()
        index = tdm.DreamIndex(stores, f, filt, "bloom", device=CPU, rfused=rf)
        assert tdm.dream_map_sam(index, batch, opts, timers=timers) == want
        assert timers.totals.get("repetitive re-seed (device)", 0) > 0
        groups = {k for k in timers.totals if k.startswith("repetitive stratum")}
        backend = "bidir" if sidecar and not indels else "enum"
        assert f"repetitive stratum 1 ({backend})" in groups, groups
        if not sidecar:
            assert not any("bidir" in k for k in groups), groups
