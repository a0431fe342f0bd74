"""Port parity for the seed stage: device index, read unpacking, seeding,
fused rank queries, exact seed search and hit expansion, each against its
JAX counterpart on the same numpy inputs (exact equality: all integers)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.ops import readpack as jrp
from dream_yara_tpu.ops.device_index import DeviceFM as JDeviceFM
from dream_yara_tpu.pipeline import seeding as jseed
from dream_yara_tpu_torch.ops import backward_search as tbs
from dream_yara_tpu_torch.ops import rank as trank
from dream_yara_tpu_torch.ops import readpack as trp
from dream_yara_tpu_torch.ops.device_index import DeviceFM
from dream_yara_tpu_torch.pipeline import seeding as tseed
from tests.conftest import random_text

# ops/__init__.py rebinds the names `rank` and `backward_search` to functions
jbs = importlib.import_module("dream_yara_tpu.ops.backward_search")
jrank = importlib.import_module("dream_yara_tpu.ops.rank")

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(31)
    genome = random_text(rng, 20_000)
    genome[5000:5010] = 4                      # a run of N in the text
    store = SeqStore.from_seqs(["a", "b"], [genome[:9000], genome[9000:]])
    fm = FMIndex.build(store.text, prefix_q=6)
    return store, fm


def test_device_index_fields_equal_jax(index):
    store, fm = index
    t = DeviceFM.from_host(fm, store.text, CPU)
    j = JDeviceFM.from_host(fm, store.text)
    for name in t._fields:
        if getattr(j, name) is None:         # sampled-SA and bidirectional fields
            assert getattr(t, name) is None, name
            continue
        assert getattr(t, name).dtype == {
            "bwt_blocks": torch.int8, "text": torch.int8}.get(name, torch.int32)
        _eq(getattr(t, name), getattr(j, name), name)


def _reads(rng, text, n, L, lens=None):
    seqs = np.full((n, L), 4, np.int8)
    lens = np.full(n, L, np.int32) if lens is None else lens
    for i in range(n):
        p = int(rng.integers(0, len(text) - L))
        seqs[i, : lens[i]] = text[p : p + lens[i]]
    seqs[rng.random(seqs.shape) < 0.02] = 4        # scattered N
    return seqs, lens


@pytest.mark.parametrize("L", [37, 64, 100])
def test_unpack_blob_and_reads_equal_jax(index, L):
    rng = np.random.default_rng(L)
    half = 48
    lens = rng.integers(0, L + 1, 40).astype(np.int32)
    seqs, _ = _reads(rng, index[0].text, 40, L, lens)
    lens_c = np.zeros(half, np.int32)
    lens_c[:40] = lens
    blob = trp.pack_blob_with_lengths(seqs, lens_c, half, L)
    np.testing.assert_array_equal(
        blob, jrp.pack_blob_with_lengths(seqs, lens_c, half, L))
    tb = torch.from_numpy(blob.view(np.int32))
    packed, nmask, tl = trp.unpack_blob(tb, half, L)
    jp, jn, jl = jrp.unpack_blob(jnp.asarray(blob), half, L)
    _eq(packed, np.asarray(jp).view(np.int32))
    _eq(nmask, np.asarray(jn).view(np.int32))
    _eq(tl, jl)
    got = trp.unpack_reads(packed, nmask, tl, L)
    assert got.dtype == torch.int8 and got.shape == (2 * half, L)
    _eq(got, jrp.unpack_reads(jp, jn, jl, L))


@pytest.mark.parametrize("rate,max_err", [(0.03, 3), (0.05, 5), (0.0, 1)])
def test_make_seeds_equal_jax(rate, max_err):
    lens = np.array([100, 0, 37, 99, 101, 1, 64, 250], np.int32)
    ppm = tseed.rate_to_ppm(rate)
    assert ppm == jseed.rate_to_ppm(rate)
    got = tseed.make_seeds(torch.from_numpy(lens), 16, ppm, max_err)
    want = jseed.make_seeds(jnp.asarray(lens), 16, ppm, max_err)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)


def test_rank_fused_equals_jax(index):
    _, fm = index
    fused = trank.build_fused_rank_rows(fm.bwt_blocks, fm.occ)
    np.testing.assert_array_equal(
        fused, jrank.build_fused_rank_rows(fm.bwt_blocks, fm.occ))
    rng = np.random.default_rng(5)
    Q = 4000
    c = rng.integers(0, 8, Q).astype(np.int32)
    i = rng.integers(0, fm.n + 1, Q).astype(np.int32)
    i[:4] = [0, fm.n, 127, 128]
    got = trank.rank_fused(torch.from_numpy(fused), torch.from_numpy(c),
                           torch.from_numpy(i))
    _eq(got, jrank.rank_fused(jnp.asarray(fused), jnp.asarray(c), jnp.asarray(i)))


def _seed_case(index, rng, n_rows=64, L=60):
    """Seeds cut from text windows: full-length, shorter than q, with N in
    their last q chars, empty (slens 0), and long enough to need every trip."""
    store, fm = index
    reads, _ = _reads(rng, store.text, n_rows, L)
    S = 4 * n_rows
    rows = np.repeat(np.arange(n_rows, dtype=np.int32), 4)
    slens = rng.integers(0, 25, S).astype(np.int32)
    slens[::9] = 3                                    # shorter than q
    slens[1::11] = 0
    starts = (rng.integers(0, L - 25, S)).astype(np.int32)
    for s in range(0, S, 13):                         # N inside the last q chars
        reads[rows[s], starts[s] + max(slens[s] - 2, 0)] = 4
    return reads, rows, starts, slens


@pytest.mark.parametrize("use_table", [False, True])
def test_seed_search_equals_jax(index, use_table):
    store, fm = index
    rng = np.random.default_rng(77 + use_table)
    reads, rows, starts, slens = _seed_case(index, rng)
    msl = 24
    t = DeviceFM.from_host(fm, store.text, CPU)
    j = JDeviceFM.from_host(fm, store.text)
    q = fm.prefix_q if use_table else 0
    got = tbs.seed_search(t.fused, t.counts, t.n, torch.from_numpy(reads),
                          torch.from_numpy(rows), torch.from_numpy(starts),
                          torch.from_numpy(slens), msl, pfx_lo=t.pfx_lo,
                          pfx_hi=t.pfx_hi, prefix_q=q)
    want = jbs.seed_search(j.bwt_blocks, j.occ, j.counts, j.n,
                           jnp.asarray(reads), jnp.asarray(rows),
                           jnp.asarray(starts), jnp.asarray(slens), msl,
                           pfx_lo=j.pfx_lo, pfx_hi=j.pfx_hi, prefix_q=q,
                           fused=j.fused)
    for g, w, name in zip(got, want, ["lo", "hi", "m_start"]):
        assert g.dtype == torch.int32
        _eq(g, w, name)
    lo, hi, _ = got
    assert int((hi > lo).sum()) > len(lo) // 3      # most seeds match


@pytest.mark.parametrize("msl", [16, 9])
def test_seed_search_chars_fe_equals_jax(index, msl):
    """The uniform-length fast path: seed chars handed over from the seed's
    end; msl 9 < the table jump depth + trips exercises the clamped columns,
    and seeds with N need the extra trips."""
    store, fm = index
    rng = np.random.default_rng(msl)
    n_rows, L = 40, 64
    reads, _ = _reads(rng, store.text, n_rows, L)
    ns = 4
    slen = L // ns
    rows = np.repeat(np.arange(n_rows, dtype=np.int32), ns)
    sidx = np.tile(np.arange(ns, dtype=np.int32), n_rows)
    slens = np.full(n_rows * ns, min(slen, msl), np.int32)
    slens[5::17] = 0
    starts = (sidx * slen + (slen - slens.clip(min=1))).astype(np.int32)
    chars_fe = np.full((n_rows * ns, msl), 4, np.int8)
    for s in range(n_rows * ns):
        seg = reads[rows[s], starts[s] : starts[s] + slens[s]][::-1]
        chars_fe[s, : len(seg)] = seg
    t = DeviceFM.from_host(fm, store.text, CPU)
    j = JDeviceFM.from_host(fm, store.text)
    got = tbs.seed_search(t.fused, t.counts, t.n, torch.from_numpy(reads),
                          torch.from_numpy(rows), torch.from_numpy(starts),
                          torch.from_numpy(slens), msl, pfx_lo=t.pfx_lo,
                          pfx_hi=t.pfx_hi, prefix_q=fm.prefix_q,
                          chars_fe=torch.from_numpy(chars_fe))
    want = jbs.seed_search(j.bwt_blocks, j.occ, j.counts, j.n,
                           jnp.asarray(reads), jnp.asarray(rows),
                           jnp.asarray(starts), jnp.asarray(slens), msl,
                           pfx_lo=j.pfx_lo, pfx_hi=j.pfx_hi,
                           prefix_q=fm.prefix_q, fused=j.fused,
                           chars_fe=jnp.asarray(chars_fe))
    for g, w, name in zip(got, want, ["lo", "hi", "m_start"]):
        _eq(g, w, name)


def test_gather_hits_equals_jax(index):
    store, fm = index
    rng = np.random.default_rng(3)
    S, cap = 500, 8
    lo = rng.integers(0, fm.n, S).astype(np.int32)
    hi = (lo + rng.integers(0, 20, S)).clip(max=fm.n).astype(np.int32)
    lo[:3], hi[:3] = [fm.n - 2, 0, 5], [fm.n, 0, 5]
    pos, mask, ovf = tbs.gather_hits(torch.from_numpy(fm.sa), torch.from_numpy(lo),
                                     torch.from_numpy(hi), cap)
    jpos, jmask, jovf = jbs.gather_hits(jnp.asarray(fm.sa), jnp.asarray(lo),
                                        jnp.asarray(hi), cap)
    _eq(mask, jmask)
    _eq(ovf, jovf)
    m = mask.numpy()
    np.testing.assert_array_equal(pos.numpy()[m], np.asarray(jpos)[m])
