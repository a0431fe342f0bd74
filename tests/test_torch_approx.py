"""Port parity for the approximate seed searches of the repetitive strata:
the layout enumeration (budget 1 and 2, indels on and off) and the search
schemes on the bidirectional index (budget 1 and 2, and the extend steps
they are built from), each against its JAX counterpart on the same numpy
inputs (exact equality: all integers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dream_yara_tpu.index.bifm import BiFMIndex
from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.ops import approx_search as jas
from dream_yara_tpu.ops import bidir_search as jbd
from dream_yara_tpu.ops.device_index import DeviceFM as JDeviceFM
from dream_yara_tpu.index.bifm import build_reverse_fused as j_build_reverse_fused
from dream_yara_tpu_torch.index.bifm import build_reverse_fused
from dream_yara_tpu_torch.index.fmindex import FMIndex as TFMIndex
from dream_yara_tpu_torch.io.seqstore import SeqStore as TSeqStore
from dream_yara_tpu_torch.ops import approx_search as tas
from dream_yara_tpu_torch.ops import bidir_search as tbd
from dream_yara_tpu_torch.ops.device_index import DeviceFM
from tests.conftest import random_text

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


@pytest.fixture(scope="module")
def bi_index():
    """Two contigs with a segment repeated 12 times (large intervals) and a
    run of N; the forward index and the reverse rows, built by each package
    (the reference's for JAX and the host BiFMIndex, the port's for the
    port: equal field for field)."""
    rng = np.random.default_rng(23)
    seg = random_text(rng, 200)
    g = np.concatenate([random_text(rng, 1500), np.tile(seg, 12),
                        random_text(rng, 2500)])
    g[3900:3910] = 4
    store = SeqStore.from_seqs(["x", "y"], [g[:3000], g[3000:]])
    fm = FMIndex.build(store.text, prefix_q=5)
    rfused, rcounts = j_build_reverse_fused(store.text)
    tstore = TSeqStore.from_seqs(["x", "y"], [g[:3000], g[3000:]])
    tfm = TFMIndex.build(tstore.text, prefix_q=5)
    trfused, trcounts = build_reverse_fused(tstore.text)
    np.testing.assert_array_equal(tstore.text, store.text)
    for k, v in vars(fm).items():
        np.testing.assert_array_equal(getattr(tfm, k), v, err_msg=k)
    np.testing.assert_array_equal(trfused, rfused)
    np.testing.assert_array_equal(trcounts, rcounts)
    return store, fm, rfused, rcounts, tfm, trfused


def _reads(rng, text, n, L, n_sub=2):
    """Text windows with up to n_sub substitutions and a few N."""
    reads = np.zeros((n, L), np.int8)
    for i in range(n):
        p = int(rng.integers(0, len(text) - L))
        r = text[p : p + L].copy()
        for _ in range(int(rng.integers(0, n_sub + 1))):
            k = int(rng.integers(0, L))
            r[k] = (r[k] + int(rng.integers(1, 4))) % 4 if r[k] < 4 else r[k]
        reads[i] = np.where(r == 5, 4, r)
    reads[rng.random(reads.shape) < 0.01] = 4
    return reads


def _seeds(rng, n_rows, L, m, short=True):
    """Two seeds a row: full windows, windows shorter than m, empty seeds."""
    S = 2 * n_rows
    rows = np.repeat(np.arange(n_rows, dtype=np.int32), 2)
    slens = np.full(S, L // 2, np.int32)
    if short:
        slens[::7] = rng.integers(1, m, len(slens[::7]))
    slens[3::11] = 0
    starts = np.tile(np.array([0, L // 2], np.int32), n_rows)
    return rows, starts, slens


@pytest.mark.parametrize("budget,indels,m", [(1, False, 20), (1, True, 20),
                                             (2, False, 12), (2, True, 9)])
def test_seed_search_edits_equals_jax(bi_index, budget, indels, m):
    store, fm, _, _, tfm, _ = bi_index
    rng = np.random.default_rng(100 * budget + indels)
    L = 48
    reads = _reads(rng, store.text, 24, L)
    rows, starts, slens = _seeds(rng, 24, L, m)
    t = DeviceFM.from_host(tfm, store.text, CPU)
    j = JDeviceFM.from_host(fm, store.text)
    got = tas.seed_search_edits(t.fused, t.counts, t.n, torch.from_numpy(reads),
                                torch.from_numpy(rows), torch.from_numpy(starts),
                                torch.from_numpy(slens), m, budget=budget,
                                indels=indels)
    want = jas.seed_search_edits(j.bwt_blocks, j.occ, j.counts, j.n,
                                 jnp.asarray(reads), jnp.asarray(rows),
                                 jnp.asarray(starts), jnp.asarray(slens), m,
                                 budget=budget, indels=indels, fused=j.fused)
    for g, w, name in zip(got, want, ["lo", "hi", "valid", "w_start"]):
        _eq(g, w, name)
    assert got[0].shape[1] == len(jas._layout_tables(m, budget, indels)[0])
    for a, b in zip(tas._layout_tables(m, budget, indels),
                    jas._layout_tables(m, budget, indels)):
        np.testing.assert_array_equal(a, b)
    assert int(got[2].sum()) > len(rows)            # most seeds place lanes


def test_extend_left_right_equal_jax_and_host(bi_index):
    """Seven-char text windows grown from their middle char, alternating
    extend_right and extend_left (live intervals), plus random-char lanes;
    every state equal to JAX's, and the first lanes to the host BiFMIndex."""
    store, fm, rfused, rcounts, tfm, trfused = bi_index
    t = DeviceFM.from_host(tfm, store.text, CPU, rfused=trfused)
    j = JDeviceFM.from_host(fm, store.text, rfused=rfused)
    host = BiFMIndex(fm=fm, rfused=rfused, rcounts=rcounts)
    rng = np.random.default_rng(5)
    Q = 300
    p = rng.integers(0, fm.n - 7, Q)
    win = store.text[p[:, None] + np.arange(7)[None, :]].astype(np.int32)
    win[Q // 2 :] = rng.integers(0, 5, (Q - Q // 2, 7))
    zero, full = np.zeros(Q, np.int32), np.full(Q, fm.n, np.int32)
    st_t = tuple(torch.from_numpy(x) for x in (zero, full, zero, full))
    st_j = tuple(jnp.asarray(x) for x in (zero, full, zero, full))
    st_h = [host.start() for _ in range(4)]
    # (direction, window column): 3 first, then right and left in turn
    for side, col in [("right", 3), ("right", 4), ("left", 2), ("right", 5),
                      ("left", 1), ("left", 0), ("right", 6)]:
        c = win[:, col]
        if side == "left":
            st_t = tbd.extend_left(t.fused, t.counts, *st_t, torch.from_numpy(c))
            st_j = jbd.extend_left(j.fused, j.counts, *st_j, jnp.asarray(c))
            st_h = [host.extend_left(s, int(c[q])) for q, s in enumerate(st_h)]
        else:
            st_t = tbd.extend_right(t.rfused, t.counts, *st_t, torch.from_numpy(c))
            st_j = jbd.extend_right(j.rfused, j.counts, *st_j, jnp.asarray(c))
            st_h = [host.extend_right(s, int(c[q])) for q, s in enumerate(st_h)]
        for a, b in zip(st_t, st_j):
            _eq(a, b, f"{side} {col}")
        np.testing.assert_array_equal(
            np.stack([x.numpy() for x in st_t], axis=1)[:4], np.array(st_h))
    live = (st_t[1] - st_t[0]).numpy()[: Q // 2]
    acgt = (win[: Q // 2] < 4).all(axis=1)
    assert acgt.sum() > Q // 3 and (live[acgt] > 0).all()   # windows stay found


@pytest.mark.parametrize("budget,m", [(1, 20), (2, 12)])
def test_bidir_seed_search_equals_jax(bi_index, budget, m):
    store, fm, rfused, _, tfm, trfused = bi_index
    rng = np.random.default_rng(7 + budget)
    L = 48
    reads = _reads(rng, store.text, 24, L)
    rows, starts, slens = _seeds(rng, 24, L, m)
    t = DeviceFM.from_host(tfm, store.text, CPU, rfused=trfused)
    j = JDeviceFM.from_host(fm, store.text, rfused=rfused)
    got = tbd.bidir_seed_search(t.fused, t.counts, t.rfused, t.counts, t.n,
                                torch.from_numpy(reads), torch.from_numpy(rows),
                                torch.from_numpy(starts),
                                torch.from_numpy(slens), m, budget=budget)
    want = jbd.bidir_seed_search(j.fused, j.counts, j.rfused, j.counts, j.n,
                                 jnp.asarray(reads), jnp.asarray(rows),
                                 jnp.asarray(starts), jnp.asarray(slens), m,
                                 budget=budget)
    for g, w, name in zip(got, want, ["lo", "hi", "valid", "w_start"]):
        _eq(g, w, name)
    valid = got[2].numpy()
    assert valid.sum() > len(rows) // 2 and not valid[slens < m].any()
