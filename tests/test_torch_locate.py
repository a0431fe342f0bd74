"""Port parity for the sampled-SA locate and the rank helpers it and the
bidirectional search use: hit-row expansion, the raw and all-symbol rank
queries, and both sampled locate editions at rates 2-16, each against its
JAX counterpart on the same numpy inputs (exact equality: all integers)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.ops import locate as jloc
from dream_yara_tpu.ops.device_index import DeviceFM as JDeviceFM
from dream_yara_tpu_torch.ops import backward_search as tbs
from dream_yara_tpu_torch.ops import locate as tloc
from dream_yara_tpu_torch.ops import rank as trank
from dream_yara_tpu_torch.index.fmindex import FMIndex as TFMIndex
from dream_yara_tpu_torch.ops.device_index import DeviceFM
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
    """Three contigs (internal sentinels, which the sampled SA marks), a run
    of N, and a text length off the 128-row block grid."""
    rng = np.random.default_rng(19)
    g = random_text(rng, 9_000)
    g[4000:4030] = 4
    store = SeqStore.from_seqs(["a", "b", "c"], [g[:2500], g[2500:6100], g[6100:]])
    fm = FMIndex.build(store.text, prefix_q=5)
    assert fm.n % 128 != 0
    tfm = TFMIndex.build(store.text, prefix_q=5)   # the port's own host index
    return store, fm, tfm


def _query_rows(rng, n, Q):
    """Random rows plus block edges (0, 127, 128, 129, ...) and the last row."""
    edges = np.array([0, 1, 127, 128, 129, 255, 256, n - 129, n - 128, n - 1])
    return np.concatenate([edges, rng.integers(0, n, Q)]).astype(np.int32)


def test_gather_hit_rows_equals_jax():
    rng = np.random.default_rng(4)
    lo = rng.integers(0, 10_000, 300).astype(np.int32)
    hi = (lo + rng.integers(0, 12, 300)).astype(np.int32)
    hi[:5] = lo[:5]                                     # empty intervals
    got = tbs.gather_hit_rows(torch.from_numpy(lo), torch.from_numpy(hi), 8)
    want = jbs.gather_hit_rows(jnp.asarray(lo), jnp.asarray(hi), 8)
    for g, w, name in zip(got, want, ["rows", "mask", "overflow"]):
        _eq(g, w, name)
    assert int(got[2].sum()) > 0 and not bool(got[1][:5].any())


@pytest.mark.parametrize("rate", [2, 4, 8, 16])
def test_locate_sampled_equals_jax_and_full_sa(index, rate):
    """Both editions on the same rows and mask as the JAX editions, and the
    fused edition equal to the full SA on every valid lane."""
    store, fm, tfm = index
    fms = fm.subsample_sa(rate)
    tfms = tfm.subsample_sa(rate)
    for k, v in vars(fms).items():
        np.testing.assert_array_equal(getattr(tfms, k), v, err_msg=k)
    t = DeviceFM.from_host(tfms, store.text, CPU)
    j = JDeviceFM.from_host(fms, store.text)
    rng = np.random.default_rng(rate)
    rows = _query_rows(rng, fm.n, 3000)
    valid = rng.random(len(rows)) < 0.8
    valid[:10] = True
    rows_t, valid_t = torch.from_numpy(rows), torch.from_numpy(valid)
    got = tloc.locate_sampled_fused(t.fused, t.counts, t.sa_mark_bits,
                                    t.sa_rank_ck, t.sa, rows_t, rate,
                                    valid=valid_t)
    mark4 = j.sa_mark_bits.reshape(-1, 4)
    want = jloc.locate_sampled_fused(
        row_fetch=lambda b: jnp.take(j.fused, b, axis=0),
        counts_fetch=lambda c: jnp.take(j.counts, c),
        mark_words_fetch=lambda g: jnp.take(
            mark4, jnp.clip(g, 0, mark4.shape[0] - 1), axis=0),
        ck_fetch=lambda g: jnp.take(
            j.sa_rank_ck, jnp.clip(g, 0, j.sa_rank_ck.shape[0] - 1)),
        sample_fetch=lambda i: jnp.take(j.sa, jnp.clip(i, 0, j.sa.shape[0] - 1)),
        rows=jnp.asarray(rows), sample_rate=rate, valid=jnp.asarray(valid))
    assert got.dtype == torch.int32
    _eq(got, want, "fused")
    np.testing.assert_array_equal(got.numpy()[valid], fm.sa[rows[valid]])

    got_p = tloc.locate_sampled_packed(t.bwt_blocks, t.occ, t.counts, t.sa,
                                       t.sa_mark_bits, t.sa_rank_ck, rows_t,
                                       rate, valid=valid_t)
    want_p = jloc.locate_sampled_packed(
        j.bwt_blocks, j.occ, j.counts, j.sa, j.sa_mark_bits, j.sa_rank_ck,
        jnp.asarray(rows), rate, valid=jnp.asarray(valid))
    _eq(got_p, want_p, "packed")


def test_device_index_sampled_fields(index):
    """The sampled fields ship as the host arrays (mark words as int32 bits)."""
    store, _, fm = index
    fms = fm.subsample_sa(8)
    t = DeviceFM.from_host(fms, store.text, CPU)
    assert t.sa_mark_bits.dtype == torch.int32 and t.sa_mark_bits.shape[0] % 4 == 0
    np.testing.assert_array_equal(t.sa_mark_bits.numpy().view(np.uint32),
                                  fms.sa_mark_bits)
    _eq(t.sa_rank_ck, fms.sa_rank_ck)
    _eq(t.sa, fms.sa)
    full = DeviceFM.from_host(fm, store.text, CPU)
    assert full.sa_mark_bits is None and full.sa_rank_ck is None
    assert full.rfused is None


def test_rank_raw_equals_jax(index):
    store, fm, tfm = index
    t = DeviceFM.from_host(tfm, store.text, CPU)
    j = JDeviceFM.from_host(fm, store.text)
    rng = np.random.default_rng(8)
    i = np.concatenate([[0, 1, 127, 128, fm.n - 1, fm.n],
                        rng.integers(0, fm.n + 1, 2000)]).astype(np.int32)
    c = rng.integers(0, 6, len(i)).astype(np.int32)
    got = trank.rank(t.bwt_blocks, t.occ, torch.from_numpy(c), torch.from_numpy(i))
    _eq(got, jrank.rank(j.bwt_blocks, j.occ, jnp.asarray(c), jnp.asarray(i)))


@pytest.mark.parametrize("n", [9_100, 9_216])
def test_rank_all_fused_rows_equals_jax(n):
    """All six symbols' occ at every in-block position, including a text on
    the block grid (the final checkpoint row) and the pad chars (7) of the
    last block, which count for no symbol."""
    rng = np.random.default_rng(n)
    text = random_text(rng, n - 1, n_rate=0.01)
    text = np.concatenate([text, [5]]).astype(np.int8)
    fm = TFMIndex.build(text)
    fused = trank.build_fused_rank_rows(fm.bwt_blocks, fm.occ)
    i = np.concatenate([np.arange(0, 300), np.arange(n - 200, n + 1),
                        rng.integers(0, n + 1, 2000)]).astype(np.int32)
    rows = fused[i >> 7]
    got = trank.rank_all_fused_rows(torch.from_numpy(rows), torch.from_numpy(i & 127))
    assert got.dtype == torch.int32 and got.shape == (len(i), 6)
    _eq(got, jrank.rank_all_fused_rows(jnp.asarray(rows), jnp.asarray(i & 127)))
    want_host = np.array([[fm.rank(c, int(q)) for c in range(6)] for q in i[:400]])
    np.testing.assert_array_equal(got.numpy()[:400], want_host)


def test_decode_fused_row_np_equals_jax(index):
    _, _, fm = index
    fused = trank.build_fused_rank_rows(fm.bwt_blocks, fm.occ)
    for b in (0, 5, fused.shape[0] - 2, fused.shape[0] - 1):
        got, want = trank.decode_fused_row_np(fused[b]), jrank.decode_fused_row_np(fused[b])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
