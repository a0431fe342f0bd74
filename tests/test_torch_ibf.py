"""Port parity for the device IBF query (ops/ibf_query.py) against the JAX
package's, on the same numpy inputs, in all four filter modes: blocked
(canonical, the default), classic, direct (kdx) and minimizer (with a
calibrated slack table). Exact equality: every output is an integer."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dream_yara_tpu.index.ibf import InterleavedBloomFilter
from dream_yara_tpu.index.kdx import DirectKmerFilter
from dream_yara_tpu.ops import ibf_query as jq
from dream_yara_tpu.ops.readpack import pack_blob_with_lengths
from dream_yara_tpu_torch.index.ibf import InterleavedBloomFilter as TIBF
from dream_yara_tpu_torch.index.kdx import DirectKmerFilter as TKdx
from dream_yara_tpu_torch.ops import ibf_query as tq
from dream_yara_tpu_torch.ops import row_gather_cuda
from tests.conftest import random_text

torch.set_num_threads(2)
B = 5
K = 19


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(t.numpy().dtype),
                                  err_msg=msg)


def _words(filt):
    return torch.from_numpy(np.ascontiguousarray(filt.words).view(np.int32))


def _filter(mode, genomes, ibf=InterleavedBloomFilter, kdx=DirectKmerFilter):
    if mode == "direct":
        f = kdx.create(B, k=10)
    else:
        f = ibf.create(
            B, size_bits=1 << 22, n_hashes=3, k=K,
            window=25 if mode == "minimizer" else 0,
            canonical=mode != "classic", blocked=mode != "classic")
    for b, g in enumerate(genomes):
        f.add_kmers(g, b)
    if mode == "minimizer":
        f.calibrate(e_max=4, trials=40, read_lens=(120,))
    return f


def _reads(rng, genomes, R=14, L=120):
    """Planted reads (some reverse-complemented, some with substitutions),
    an N inside one, a read shorter than k, a short read and a random one."""
    reads = np.full((R, L), 4, np.int8)
    lens = np.full(R, L, np.int32)
    for i in range(R):
        g = genomes[i % len(genomes)]
        p = int(rng.integers(0, len(g) - L))
        w = g[p : p + L].copy()
        if i % 3 == 1:
            w = np.where(w < 4, 3 - w, w)[::-1]
        if i % 4 == 2:
            j = rng.integers(0, L, 3)
            w[j] = (w[j] + 1) % 4
        reads[i] = w
    reads[1, 50] = 4
    lens[2] = K - 3
    reads[2, K - 3 :] = 4
    lens[3] = 40
    reads[3, 40:] = 4
    reads[4] = random_text(rng, L)
    return reads, lens


@pytest.fixture(scope="module")
def genomes():
    rng = np.random.default_rng(17)
    return [random_text(rng, 3000) for _ in range(B)]


@pytest.fixture(scope="module")
def filters(genomes):
    return {m: _filter(m, genomes)
            for m in ("blocked", "classic", "direct", "minimizer")}


@pytest.fixture(scope="module")
def tfilters(genomes, filters):
    """The same filters built by the port's own host classes: their words
    and slack tables equal the reference's."""
    out = {m: _filter(m, genomes, TIBF, TKdx) for m in filters}
    for m, f in filters.items():
        np.testing.assert_array_equal(out[m].words, f.words, err_msg=m)
        np.testing.assert_array_equal(getattr(out[m], "slack_table", None),
                                      getattr(f, "slack_table", None), err_msg=m)
    return out


def test_fmix32_and_mul32_wrap_like_uint32():
    rng = np.random.default_rng(3)
    h = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]        # bit 31 set / clear
    t = torch.from_numpy(h.astype(np.int64))
    _eq(tq._fmix32(t), jq._fmix32(jnp.asarray(h)))
    _eq(tq._mul32(t, 0x85EBCA6B), jnp.asarray(h) * jnp.uint32(0x85EBCA6B))


@pytest.mark.parametrize("canonical", [False, True])
def test_kmer_windows_equal(genomes, canonical):
    reads, lens = _reads(np.random.default_rng(4), genomes)
    got = tq.kmer_windows_dev(torch.from_numpy(reads), torch.from_numpy(lens),
                              K, canonical=canonical)
    want = jq.kmer_windows_dev(jnp.asarray(reads), jnp.asarray(lens), K,
                               canonical=canonical)
    for g, w, name in zip(got, want, ("lo", "hi", "valid")):
        _eq(g, w, name)
    assert not got[2][2].any()                              # shorter than k


def test_minimizer_select_equal(genomes):
    reads, lens = _reads(np.random.default_rng(5), genomes)
    lo, hi, valid = jq.kmer_windows_dev(jnp.asarray(reads), jnp.asarray(lens),
                                        K, canonical=True)
    mix = lo ^ (hi * jnp.uint32(0x85EBCA6B))
    want = jq.minimizer_select_dev(mix, valid, jnp.asarray(lens), 25, K)
    got = tq.minimizer_select_dev(torch.from_numpy(np.asarray(mix).astype(np.int64)),
                                  torch.from_numpy(np.array(valid)),
                                  torch.from_numpy(lens), 25, K)
    _eq(got, want)


def _mode_kw(f):
    return dict(window=getattr(f, "window", 0),
                canonical=bool(getattr(f, "canonical", 0)),
                blocked=bool(getattr(f, "blocked", 0)),
                direct=bool(getattr(f, "direct", 0)))


@pytest.mark.parametrize("mode", ["blocked", "blocked_rows", "blocked_chunked",
                                  "classic", "direct", "minimizer"])
def test_ibf_bin_counts_equal(genomes, filters, tfilters, mode, monkeypatch):
    """blocked_rows: the host_block_rows layout (block_s > 0) that
    classify uploads; blocked_chunked: several read chunks per call."""
    f = filters[mode.split("_")[0]]
    tf = tfilters[mode.split("_")[0]]
    reads, lens = _reads(np.random.default_rng(6), genomes)
    kw = dict(_mode_kw(f), n_bins=B)
    want = jq.ibf_bin_counts(jnp.asarray(f.words), jnp.asarray(reads),
                             jnp.asarray(lens), f.k, f.n_hashes, **kw)
    words = _words(tf)
    if mode == "blocked_rows":
        rows, S = tq.host_block_rows(tf.words, B)
        jrows, jS = jq.host_block_rows(f.words, B)
        assert S == jS and np.array_equal(rows, jrows)
        words = torch.from_numpy(rows.view(np.int32))
        kw["block_s"] = S
    if mode == "blocked_chunked":
        monkeypatch.setattr(tq, "LANE_BUDGET_WORDS", 64 * 102 * 3)
    got = tq.ibf_bin_counts(words, torch.from_numpy(reads),
                            torch.from_numpy(lens), f.k, f.n_hashes, **kw)
    _eq(got[0], want[0], "counts")
    _eq(got[1], want[1], "n_sel")
    assert row_gather_cuda.kernel.launches == 0               # CPU: plain edition


def test_classify_thresholds_equal(tfilters):
    rng = np.random.default_rng(7)
    lens = rng.integers(0, 300, 64).astype(np.int32)
    n_sel = rng.integers(0, 80, 64).astype(np.int32)
    slack = np.asarray(tfilters["minimizer"].slack_table, np.int32)
    for window, tab in ((0, None), (25, None), (25, slack)):
        want = jq.classify_thresholds(jnp.asarray(lens), jnp.asarray(n_sel), K,
                                      window, 300,
                                      None if tab is None else jnp.asarray(tab))
        got = tq.classify_thresholds(torch.from_numpy(lens),
                                     torch.from_numpy(n_sel), K, window, 300,
                                     None if tab is None else torch.from_numpy(tab))
        _eq(got, want, f"window={window} slack={tab is not None}")


@pytest.mark.parametrize("mode", ["blocked", "classic", "direct", "minimizer"])
def test_ibf_classify_packed_equal(genomes, tfilters, mode):
    """The packed candidate mask of a blob, thresholds included, as the
    classifier calls it (blocked: host_block_rows layout, n_bins = B), on
    the port's filter (equal to the reference's, see `tfilters`)."""
    f = tfilters[mode]
    reads, lens = _reads(np.random.default_rng(8), genomes, R=20)
    L = reads.shape[1]
    half = len(lens)
    blob = pack_blob_with_lengths(reads, lens, half, L)
    kw = dict(_mode_kw(f), half=half, L=L, k=f.k, n_hashes=f.n_hashes,
              rate_ppm=300, n_bins=B)
    slack = getattr(f, "slack_table", None)
    if getattr(f, "blocked", 0):
        rows, S = tq.host_block_rows(f.words, B)
        jw, tw = jnp.asarray(rows), torch.from_numpy(rows.view(np.int32))
        kw["block_s"] = S
    else:
        w = np.ascontiguousarray(f.words[:, :1])
        jw, tw = jnp.asarray(w), torch.from_numpy(w.view(np.int32))
    want = jq.ibf_classify_packed(
        jw, jnp.asarray(blob), None if slack is None else jnp.asarray(slack), **kw)
    got = tq.ibf_classify_packed(
        tw, torch.from_numpy(blob.view(np.int32)),
        None if slack is None else torch.from_numpy(np.asarray(slack, np.int32)),
        **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    # every planted read routes to its bin (random read 4 may route nowhere)
    bits = (got.numpy().view(np.uint32)[:, 0, None] >> np.arange(B)) & 1
    planted = [i for i in range(half) if i not in (2, 3, 4)]
    assert all(bits[i, i % B] for i in planted)


def test_classify_packed_sets_bit_31():
    """A 64-bin filter with every bit set: the packed word of every read
    has bit 31 set, and the port's int32 words carry it."""
    f = TIBF.create(40, size_bits=1 << 20, n_hashes=3, k=K)
    f.words[:] = 0xFFFFFFFF
    rng = np.random.default_rng(9)
    reads = rng.integers(0, 4, (6, 100)).astype(np.int8)
    lens = np.full(6, 100, np.int32)
    blob = pack_blob_with_lengths(reads, lens, 6, 100)
    rows, S = tq.host_block_rows(f.words, 40)
    kw = dict(half=6, L=100, k=K, n_hashes=3, rate_ppm=300, canonical=True,
              blocked=True, n_bins=40, block_s=S)
    want = np.asarray(jq.ibf_classify_packed(jnp.asarray(rows),
                                             jnp.asarray(blob), None, **kw))
    got = tq.ibf_classify_packed(torch.from_numpy(rows.view(np.int32)),
                                 torch.from_numpy(blob.view(np.int32)), None, **kw)
    assert (want[:, 0] >> 31 == 1).all()
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
