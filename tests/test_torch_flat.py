"""Port parity for the flat multi-bin step's parts: the stacked device set,
the stacked-text verify (plain edition, against the TPU kernel's hooked
launcher in Pallas interpret mode), the slot pool and the flat map step,
against the JAX package on the same numpy inputs (exact equality)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.ops.device_index import DeviceFMSet as JDeviceFMSet
from dream_yara_tpu.ops.pallas_verify import banded_verify_pallas_hooked
from dream_yara_tpu.ops.readpack import unpack_blob as junpack_blob
from dream_yara_tpu.ops.readpack import unpack_reads as junpack_reads
from dream_yara_tpu.ops.verify import banded_verify as jbanded_verify
from dream_yara_tpu.pipeline import flat_step as jflat
from dream_yara_tpu.utils.alphabet import revcomp
from dream_yara_tpu_torch.index.fmindex import FMIndex as TFMIndex
from dream_yara_tpu_torch.io.seqstore import SeqStore as TSeqStore
from dream_yara_tpu_torch.ops import banded_verify_cuda, row_gather_cuda
from dream_yara_tpu_torch.ops.device_index import DeviceFMSet
from dream_yara_tpu_torch.ops.readpack import pack_blob_with_lengths
from dream_yara_tpu_torch.ops.verify import banded_verify
from dream_yara_tpu_torch.pipeline import flat_step as tflat
from dream_yara_tpu_torch.pipeline.map_step import max_seed_len_static
from tests.conftest import mutate, random_text

torch.set_num_threads(2)
CPU = torch.device("cpu")
t_ = torch.from_numpy


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=msg)


def _bins(seed, rate=1, qs=(7, 7, 7), lens=(3000, 4200, 3500), port=False):
    """Bins of unequal length (the first with a tandem repeat, so seeds
    overflow), each FM index built at its own prefix q, by the reference's
    host classes or (port=True) by the port's."""
    SeqStore_, FMIndex_ = (TSeqStore, TFMIndex) if port else (SeqStore, FMIndex)
    rng = np.random.default_rng(seed)
    unit = random_text(rng, 40)
    genomes = [np.concatenate([np.tile(unit, 20), random_text(rng, lens[0] - 800)])]
    genomes += [random_text(rng, n) for n in lens[1:]]
    stores = [SeqStore_.from_seqs([f"g{b}"], [g]) for b, g in enumerate(genomes)]
    fms = [FMIndex_.build(st.text, sample_rate=rate, prefix_q=q)
           for st, q in zip(stores, qs)]
    return rng, genomes, stores, fms


@pytest.mark.parametrize("rate,qs,lean", [(1, (7, 7, 7), False),
                                          (4, (7, 7, 7), True),
                                          (1, (6, 7, 5), False)])
def test_device_fmset_equals_jax(rate, qs, lean):
    """Every field equals the reference's build_np on the same host
    indexes, padding to 4 bins included; bin(b) views the stack; a bin
    built at another q is rebuilt at the common q (on both packages'
    own copies)."""
    _, _, stores, fms = _bins(1, rate, qs, port=True)
    _, _, _, fms_j = _bins(1, rate, qs)
    texts = [st.text for st in stores]
    got = DeviceFMSet.build_np(fms, texts, pad_bins_to=4, lean=lean)
    want = JDeviceFMSet.build_np(fms_j, texts, pad_bins_to=4, lean=lean)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), k
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, k
            _eq(g, w, k)
    assert [fm.prefix_q for fm in fms] == [min(qs)] * 3
    dset = DeviceFMSet.from_host(fms, texts, CPU, pad_bins_to=4, lean=lean)
    assert dset.n_bins == 4 and dset.prefix_q == min(qs)
    for k, w in want.items():
        t = getattr(dset, k)
        if w is None:
            assert t is None, k
            continue
        assert t.device == CPU
        _eq(t.numpy().view(w.dtype) if k == "sa_mark_bits" else t.numpy(), w, k)
    view = dset.bin(1)
    assert view.text.data_ptr() == dset.text[1].data_ptr()       # no copy
    _eq(view.fused.numpy(), want["fused"][1])
    assert int(view.n) == fms[1].n
    if rate > 1:
        _eq(view.sa_mark_bits.numpy().view(np.uint32), want["sa_mark_bits"][1].reshape(-1))


def _stacked_case(seed, lens, C, L, E):
    """tests/test_pallas.py's stacked layout: the (B, n_text) stack padded
    with 7, reads cut at their anchor with edits, edge anchors (0, 1, the
    bin end, negative, past the end)."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    texts = [random_text(rng, n) for n in lens]
    n_text = max(lens)
    stack = np.full((B, n_text), 7, np.int8)
    for b, t in enumerate(texts):
        stack[b, : len(t)] = t
    bin_lane = rng.integers(0, B, C).astype(np.int32)
    anchors = np.zeros(C, np.int32)
    reads = np.full((C, L), 4, np.int8)
    lens_r = np.zeros(C, np.int32)
    for i in range(C):
        t = texts[bin_lane[i]]
        anchors[i] = int(rng.integers(0, len(t) - L))
        r = mutate(rng, t[anchors[i] : anchors[i] + L - 10].copy(),
                   n_sub=int(rng.integers(0, 3)), n_ins=int(rng.integers(0, 2)),
                   n_del=int(rng.integers(0, 2)))
        reads[i, : len(r)] = r
        lens_r[i] = len(r)
    edge = [(0, 0), (1, 1), (0, lens[0] - 10), (2, 3), (1, 2), (2, lens[2] - 1),
            (0, -2), (1, lens[1] + 3), (2, lens[2] - L + 20)]
    for i, (b, a) in enumerate(edge):
        bin_lane[i], anchors[i] = b, a
    lens_r[len(edge)] = 0
    return stack, np.asarray(lens, np.int32), bin_lane, anchors, reads, lens_r


def test_stacked_verify_equals_pallas_hooked():
    """The stacked plain edition against banded_verify_pallas_hooked (the
    TPU kernel's stacked-text launcher, interpret mode) and the reference's
    XLA verify, both through the flat step's block fetch over the same
    stack; with one bin it equals the single-bin call."""
    E = 4
    stack, bin_n, bin_lane, anchors, reads, lens_r = _stacked_case(
        7, [2000, 2128, 1900], 300, 90, E)
    C = len(anchors)
    rows = np.arange(C, dtype=np.int32)
    got = banded_verify(t_(stack), t_(anchors), t_(reads), t_(rows), t_(lens_r),
                        E, lane_bin=t_(bin_lane), bin_n=t_(bin_n))

    # the flat step's text-block fetch: 128-char blocks of the stack, 7 for
    # blocks out of range (pipeline/flat_step.py:277-281)
    B, n_text = stack.shape
    pad128 = (-n_text) % 128
    ntb = (n_text + pad128) // 128
    tb_flat = jnp.asarray(np.pad(stack, ((0, 0), (0, pad128)),
                                 constant_values=7).reshape(B * ntb, 128))
    bl = jnp.asarray(bin_lane)

    def tb_fetch(brow):
        bad = (brow < 0) | (brow >= ntb)
        r = jnp.take(tb_flat, jnp.clip(bl * ntb + brow, 0, tb_flat.shape[0] - 1),
                     axis=0)
        return jnp.where(bad[:, None], jnp.int8(7), r)

    args = (jnp.asarray(anchors), jnp.asarray(reads), jnp.asarray(rows),
            jnp.asarray(lens_r))
    pallas = banded_verify_pallas_hooked(*args, max_err=E, tblock_fetch=tb_fetch,
                                         interpret=True)
    xla = jbanded_verify(None, *args, max_err=E, tblock_fetch=tb_fetch)
    for g, p, x, name in zip(got, pallas, xla, ["dist", "begin", "end"]):
        _eq(g.numpy(), p, name)
        _eq(g.numpy(), x, name)
    assert int((got[0] <= E).sum()) > C // 2

    one = banded_verify(t_(stack[:1]), t_(anchors), t_(reads), t_(rows), t_(lens_r),
                        E, lane_bin=torch.zeros(C, dtype=torch.int32),
                        bin_n=t_(bin_n[:1]))
    single = banded_verify(t_(stack[0]), t_(anchors), t_(reads), t_(rows),
                           t_(lens_r), E)
    for a, b in zip(one, single):
        assert torch.equal(a, b)
    # the entry every caller goes through takes the plain edition on the CPU
    routed = banded_verify_cuda.banded_verify(
        t_(stack), t_(anchors), t_(reads), t_(rows), t_(lens_r), E,
        lane_bin=t_(bin_lane), bin_n=t_(bin_n))
    assert all(torch.equal(a, b) for a, b in zip(routed, got))
    assert banded_verify_cuda.kernel.launches == 0


@pytest.mark.parametrize("n_loc,B,t_cap", [(40, 5, 64), (40, 5, 30),
                                           (7, 3, 1), (1, 1, 4)])
def test_slot_pool_equals_jax(n_loc, B, t_cap):
    """Bin-major slots; a pool smaller than the routed pairs counts the
    rest as overflow."""
    rng = np.random.default_rng(n_loc * 10 + t_cap)
    cand = rng.random((n_loc, B)) < 0.4
    got = tflat.slot_pool(t_(cand), t_cap)
    want = jflat.slot_pool(jnp.asarray(cand), t_cap)
    for g, w, name in zip(got, want, ["read_slot", "bin_slot", "valid", "overflow"]):
        _eq(g.numpy(), w, name)
    assert int(got[3]) == max(int(cand.sum()) - t_cap, 0)


def test_slot_pool_of_no_reads():
    """A batch of no reads gives an empty pool. The reference raises
    instead (pos[-1] of an empty cumsum, flat_step.py:52; ROADMAP Queue 3):
    this test flips when that is fixed."""
    got = tflat.slot_pool(torch.zeros((0, 4), dtype=torch.bool), 8)
    assert not got[2].any() and int(got[3]) == 0
    assert got[0].shape == got[1].shape == (8,)
    with pytest.raises(IndexError):
        jflat.slot_pool(jnp.zeros((0, 4), bool), 8)


@pytest.fixture(scope="module")
def flat_db():
    rng, genomes, stores, fms = _bins(3)
    rate4 = [fm.subsample_sa(4) for fm in fms]
    _, _, _, tfms = _bins(3, port=True)
    trate4 = [fm.subsample_sa(4) for fm in tfms]
    names, reads = [], []
    for i in range(36):
        b = i % 3
        g = genomes[b]
        p = int(rng.integers(0, 800)) if (b == 0 and i % 2) else \
            int(rng.integers(0, len(g) - 100))
        r = mutate(rng, g[p : p + 100].copy(), n_sub=int(rng.integers(0, 3)))
        reads.append(revcomp(r) if i % 3 == 1 else r)
    reads.append(random_text(rng, 100))
    reads.append(genomes[1][50:140].copy())               # a shorter read
    return rng, stores, (fms, tfms), (rate4, trate4), reads


@pytest.mark.parametrize("case", ["full", "full_q0", "sampled", "sampled_spill",
                                  "ragged"])
def test_flat_map_step_equals_jax(flat_db, case):
    """Every counter and demand of the flat step, and the lanes where ok,
    equal the JAX step's on the same slots: full and rate-4 SA, a loc_cap
    small enough to spill, the q-mer table off, lengths uniform or not."""
    rng, stores, fms, rate4, reads = flat_db
    fm_list, tfm_list = rate4 if case.startswith("sampled") else fms
    texts = [st.text for st in stores]
    reads = reads if case == "ragged" else reads[:-1]
    n = len(reads)
    L = 100
    lens = np.array([len(r) for r in reads], np.int32)
    seqs = np.full((n, L), 4, np.int8)
    for i, r in enumerate(reads):
        seqs[i, : len(r)] = r
    blob = pack_blob_with_lengths(seqs, lens, n, L)
    packed, nmask, lengths = junpack_blob(jnp.asarray(blob), n, L)
    reads2 = np.array(junpack_reads(packed, nmask, lengths, L))
    cand = np.random.default_rng(5).random((n, 3)) < 0.5
    cand[np.arange(n), np.arange(n) % 3] = True
    t_cap = int(cand.sum()) - 5                       # a few pairs left out
    slots = jflat.slot_pool(jnp.asarray(cand), t_cap)
    q = 0 if case == "full_q0" else 7
    kw = dict(half_loc=n, rate_ppm=300, max_errors=3, capacity=8,
              max_slen=max_seed_len_static(L, 300), prefix_q=q,
              compact_cap=2 * t_cap, uniform_len=case != "ragged",
              sample_rate=fm_list[0].sample_rate,
              cap2l=0.02 if case == "sampled_spill" else 4.0)
    want = jflat.flat_map_step(JDeviceFMSet.from_host(fm_list, texts),
                               jnp.asarray(reads2), jnp.asarray(lens), *slots[:3],
                               **kw)
    tset = DeviceFMSet.from_host(tfm_list, texts, CPU)
    got = tflat.flat_map_step(tset, t_(reads2), t_(lens),
                              *(t_(np.array(s)) for s in slots[:3]), **kw)
    for f in ("seed_lo", "seed_hi", "overflow", "m_start", "overflow_total",
              "n_spilled", "v_need", "loc_need", "ok"):
        _eq(getattr(got, f).numpy(), getattr(want, f), f)
    ok = got.ok.numpy()
    for f in ("row", "begin", "end", "dist"):
        _eq(getattr(got, f).numpy()[ok], np.asarray(getattr(want, f))[ok], f)
    if case == "sampled_spill":      # loc_cap = 8 lanes: most seeds spill
        assert int(got.loc_need) > 8 and int(got.overflow_total) > 0
    else:
        assert ok.sum() >= n
    if case == "full":
        assert int(got.overflow_total) > 0             # the tandem repeat
    assert row_gather_cuda.kernel.launches == 0
