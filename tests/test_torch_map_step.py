"""Port parity for the map step: dedup and compaction on their own, then the
whole packed single-bin step, field by field, against the JAX step on the
same blob (exact equality: all outputs are integers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.ops.device_index import DeviceFM as JDeviceFM
from dream_yara_tpu.pipeline import map_step as jms
from dream_yara_tpu.utils.alphabet import revcomp
from dream_yara_tpu_torch.index.fmindex import FMIndex as TFMIndex
from dream_yara_tpu_torch.ops.device_index import DeviceFM
from dream_yara_tpu_torch.ops.readpack import pack_blob_with_lengths
from dream_yara_tpu_torch.pipeline import map_step as tms
from tests.conftest import mutate, random_text

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=msg)


def _anchor_lanes(rng, R, slots):
    """Anchors with many within-row duplicates and a sparse validity mask."""
    A = rng.integers(0, 6, (R, slots)).astype(np.int32) * 10
    V = rng.random((R, slots)) < 0.3
    V[rng.random(R) < 0.3] = False                    # rows with no kept lane
    return A, V


@pytest.mark.parametrize("slots", [8, 32, 72])
def test_pairwise_dedup_equals_jax(slots):
    rng = np.random.default_rng(slots)
    A, V = _anchor_lanes(rng, 50, slots)
    got = tms.pairwise_dedup(torch.from_numpy(A), torch.from_numpy(V))
    _eq(got.numpy(), jms.pairwise_dedup(jnp.asarray(A), jnp.asarray(V)))


@pytest.mark.parametrize("cap2", [1, 16, 40, 400])
def test_global_compact_equals_jax(cap2):
    """cap2 below the kept-lane total spills (n_spilled > 0)."""
    rng = np.random.default_rng(cap2)
    A, V = _anchor_lanes(rng, 60, 16)
    keep = jms.pairwise_dedup(jnp.asarray(A), jnp.asarray(V))
    row_ids = np.arange(60, dtype=np.int32) + 1000
    got = tms.global_compact(torch.from_numpy(A), torch.from_numpy(np.array(keep)),
                             torch.from_numpy(row_ids), cap2)
    want = jms.global_compact(jnp.asarray(A), keep, jnp.asarray(row_ids), cap2)
    for g, w, name in zip(got, want, ["vrow", "vanch", "keep", "n_spilled"]):
        assert g.dtype == (torch.bool if name == "keep" else torch.int32)
        _eq(g.numpy(), w, name)


@pytest.mark.parametrize("verify_capacity", [None, 2, 5])
def test_dedup_compact_equals_jax(verify_capacity):
    rng = np.random.default_rng(11)
    A, V = _anchor_lanes(rng, 40, 12)
    row_ids = np.arange(40, dtype=np.int32)
    got = tms.dedup_compact(torch.from_numpy(A), torch.from_numpy(V),
                            torch.from_numpy(row_ids), verify_capacity)
    want = jms.dedup_compact(jnp.asarray(A), jnp.asarray(V),
                             jnp.asarray(row_ids), verify_capacity)
    for g, w, name in zip(got, want, ["vrow", "vanch", "keep", "n_spilled"]):
        _eq(g.numpy(), w, name)


@pytest.fixture(scope="module")
def chunk():
    """A two-contig bin and one chunk of reads: planted reads with
    substitutions and indels on both strands, reads across the contig
    boundary, unmappable reads, and a short last read."""
    rng = np.random.default_rng(41)
    genome = random_text(rng, 30_000)
    genome[300:2300] = np.tile(random_text(rng, 50), 40)   # a tandem repeat
    store = SeqStore.from_seqs(["c0", "c1"], [genome[:17_000], genome[17_000:]])
    fm = FMIndex.build(store.text, prefix_q=7)
    L, n = 100, 90
    seqs = np.full((n, L), 4, np.int8)
    for i in range(n):
        p = int(rng.integers(0, len(store.text) - L - 5))
        r = mutate(rng, store.text[p : p + L].copy(),
                   n_sub=int(rng.integers(0, 3)), n_ins=int(i % 7 == 0),
                   n_del=int(i % 5 == 0))[:L]
        r[r > 3] = 4
        if i % 2:
            r = revcomp(r)
        seqs[i, : len(r)] = r
    seqs[-3:] = rng.integers(0, 4, (3, L))
    seqs[10:14, :] = store.text[400:500]                    # in the repeat
    lens = np.full(n, L, np.int32)
    lens[-1] = 91
    seqs[-1, 91:] = 4
    tfm = TFMIndex.build(store.text, prefix_q=7)    # the port's own host index
    return store, fm, tfm, seqs, lens


def _run_steps(store, fm, tfm, seqs, lens, half, uniform_len, **kw):
    L = seqs.shape[1]
    lens_c = np.zeros(half, np.int32)
    lens_c[: len(lens)] = lens
    blob = pack_blob_with_lengths(seqs, lens_c, half, L)
    rate_ppm, max_err = 300, 3
    step_kw = dict(half=half, L=L, rate_ppm=rate_ppm, max_errors=max_err,
                   capacity=4, max_slen=jms.max_seed_len_static(L, rate_ppm),
                   prefix_q=fm.prefix_q, uniform_len=uniform_len, **kw)
    t = tms.single_bin_map_step_packed(
        DeviceFM.from_host(tfm, store.text, CPU),
        torch.from_numpy(blob.view(np.int32)), **step_kw)
    j = jms.single_bin_map_step_packed(
        JDeviceFM.from_host(fm, store.text), jnp.asarray(blob),
        use_pallas=False, **step_kw)
    R2 = 2 * half
    got = tms.unbundle_out(t[0].numpy(), *(x.numpy() for x in t[1:]), L,
                           max_err, R2)
    want = jms.unbundle_out(np.asarray(j[0]), *(np.asarray(x) for x in j[1:]),
                            L, max_err, R2)
    assert t[0].dtype == torch.int32
    _eq(t[0].numpy(), np.asarray(j[0]), "bundle")
    return got, want


@pytest.mark.parametrize("mode", ["compact", "compact_spill", "dense",
                                  "per_row", "gather_path", "sampled"])
def test_map_step_packed_equals_jax(chunk, mode):
    store, fm, tfm, seqs, lens = chunk
    uniform = mode != "gather_path"
    if uniform:   # the fast path needs every read at full length
        seqs, lens = seqs[:-1], lens[:-1]
    if mode == "sampled":   # hits located by the LF walk in both packages
        fm, tfm = fm.subsample_sa(4), tfm.subsample_sa(4)
    kw = {"compact": dict(compact_cap=256), "compact_spill": dict(compact_cap=24),
          "dense": dict(verify_capacity=None), "per_row": dict(verify_capacity=3),
          "gather_path": dict(compact_cap=256),
          "sampled": dict(compact_cap=256, sample_rate=4)}[mode]
    got, want = _run_steps(store, fm, tfm, seqs, lens, 128, uniform, **kw)
    ok = np.asarray(got.ok)
    _eq(ok, want.ok, "ok")
    for f in ("row", "begin", "end", "dist"):
        _eq(np.asarray(getattr(got, f))[ok], np.asarray(getattr(want, f))[ok], f)
    for f in ("overflow_total", "n_spilled", "seed_lo", "seed_hi", "overflow",
              "m_start"):
        _eq(getattr(got, f), getattr(want, f), f)
    assert ok.sum() > 0
    if mode == "compact_spill":
        assert int(got.n_spilled) > 0
    assert int(got.overflow_total) > 0          # the tandem-repeat reads
