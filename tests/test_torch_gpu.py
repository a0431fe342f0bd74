"""Card-only tests of the port: the CUDA banded-verify kernel (single-bin
and stacked-text entries) and the row-gather kernel against their plain
PyTorch editions on the same card, and the sampled locate, the repetitive
step and the flat mesh step on the card against the CPU; exact equality
(integer outputs).

Skips where there is no CUDA device. On a machine with a card and without
JAX (tests/conftest.py imports JAX), run it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from dream_yara_tpu_torch.ops import (banded_verify_cuda, row_gather,
                                      row_gather_cuda, verify)
from dream_yara_tpu_torch.verify_cases import (edge_case, stacked_case,
                                               verify_case)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("C,L,E", [(4096, 100, 3), (2048, 250, 12),
                                   (1024, 80, 1), (512, 120, 31)])
def test_kernel_equals_plain_edition(cuda_device, C, L, E):
    rng = np.random.default_rng(C + E)
    text = rng.integers(0, 4, 200_000).astype(np.int8)
    text[1000:1020] = 4
    text[5000] = 5
    case = edge_case(text, *verify_case(rng, text, C, L, E))
    args = [torch.from_numpy(a).to(cuda_device) for a in (text, *case)]
    before = banded_verify_cuda.kernel.launches
    got = banded_verify_cuda.banded_verify(*args, max_err=E)
    want = verify.banded_verify(*args, max_err=E)
    torch.cuda.synchronize()
    assert banded_verify_cuda.kernel.launches == before + 1
    for g, w, name in zip(got, want, ["dist", "begin", "end"]):
        assert g.device.type == "cuda" and g.dtype == torch.int32
        assert torch.equal(g, w), name


@pytest.mark.parametrize("nb,W,Q,idx_dtype", [
    (45_314, 24, 100_000, torch.int32),      # fused rank rows (config-2 bin)
    (36_000, 128, 50_000, torch.int64),      # the padded rows of _dma_kernel
    (524_288, 64, 200_000, torch.int64),     # config-2 IBF block rows
    (1_000, 8, 777, torch.int32),            # a width without its own template
])
def test_gather_kernel_equals_plain_edition(cuda_device, nb, W, Q, idx_dtype):
    g = torch.Generator(device=cuda_device).manual_seed(nb + W)
    table = torch.randint(-2**31, 2**31 - 1, (nb, W), dtype=torch.int32,
                          generator=g, device=cuda_device)
    idx = torch.randint(0, nb, (Q,), dtype=idx_dtype, generator=g,
                        device=cuda_device)
    idx[:6] = torch.tensor([0, nb - 1, -1, -1000, nb, nb + 99], dtype=idx_dtype)
    before = row_gather_cuda.kernel.launches
    got = row_gather_cuda.gather_rows(table, idx)
    want = row_gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert row_gather_cuda.kernel.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, want)
    assert row_gather_cuda.gather_rows(table, idx[:0]).shape == (0, W)


@pytest.fixture(scope="module")
def rich_bin():
    """A 200 kbp repeat-rich bin, its rate-8 index, reverse rows and 64
    reads (half from repeat copies) as a (fwd | revcomp) row matrix."""
    from dream_yara_tpu_torch._shared import (FMIndex, SeqStore,
                                              build_reverse_fused,
                                              repeat_rich_genome, sample_reads)

    rng = np.random.default_rng(9)
    g, ann = repeat_rich_genome(rng, 200_000, alu_count=100, tandem_loci=4,
                                n_runs=2)
    store = SeqStore.from_seqs(["g"], [g])
    fm = FMIndex.build(store.text)
    reads, _ = sample_reads(rng, g, 64, regions=ann["alu"] + ann["tandem"])
    R = np.stack(reads).astype(np.int8)
    rc = np.where(R[:, ::-1] < 4, 3 - R[:, ::-1], R[:, ::-1])
    return (store, fm, fm.subsample_sa(8), build_reverse_fused(store.text)[0],
            np.concatenate([R, rc]), np.full(64, 100, np.int32))


def test_sampled_locate_on_card_equals_full_sa(cuda_device, rich_bin):
    from dream_yara_tpu_torch.ops.device_index import DeviceFM
    from dream_yara_tpu_torch.ops.locate import locate_sampled_fused

    store, fm, fm8, _, _, _ = rich_bin
    d = DeviceFM.from_host(fm8, store.text, cuda_device)
    rows = torch.arange(fm.n, dtype=torch.int32, device=cuda_device)
    before = row_gather_cuda.kernel.launches
    got = locate_sampled_fused(d.fused, d.counts, d.sa_mark_bits, d.sa_rank_ck,
                               d.sa, rows, 8)
    assert row_gather_cuda.kernel.launches == before + 7      # one a LF step
    np.testing.assert_array_equal(got.cpu().numpy(), fm.sa)


@pytest.mark.parametrize("backend,budget,indels,m", [
    ("enum", 1, True, 32), ("enum", 2, False, 16),
    ("bidir", 1, False, 32), ("bidir", 2, False, 16)])
def test_repetitive_step_on_card_equals_cpu(cuda_device, rich_bin, backend,
                                            budget, indels, m):
    from dream_yara_tpu_torch.ops.device_index import DeviceFM
    from dream_yara_tpu_torch.pipeline.map_step import repetitive_map_step

    store, _, fm8, rfused, reads, lens = rich_bin
    rows = np.arange(0, 128, 2, dtype=np.int32)
    mask = np.arange(64) < 60
    kw = dict(rate_ppm=300, max_errors=3, capacity=4, max_slen_rep=m,
              budget=budget, indels=indels, backend=backend, sample_rate=8)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        d = DeviceFM.from_host(fm8, store.text, dev, rfused=rfused)
        args = [torch.from_numpy(a).to(dev) for a in (reads, lens, rows, mask)]
        outs.append([x.cpu() for x in repetitive_map_step(d, *args, **kw)])
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    assert int(outs[0][4].sum()) > 0


@pytest.mark.parametrize("lens,C,L,E,edges", [
    ([400_001] * 16, 20_000, 100, 3, False),          # config-5's bins, fewer
    ([2000 + 128 * b for b in range(5)], 4096, 100, 3, True),
    ([3000, 1000, 2500], 2048, 150, 4, True),
    ([5000, 7000], 1024, 120, 31, True)])
def test_stacked_kernel_equals_plain_edition(cuda_device, lens, C, L, E, edges):
    rng = np.random.default_rng(C + E)
    text, bin_n, lane_bin, *case = (torch.from_numpy(a).to(cuda_device) for a in
                                    stacked_case(rng, lens, C, L, E, edges))
    v = banded_verify_cuda.kernel
    before, stacked_before = v.launches, v.stacked_launches
    got = banded_verify_cuda.banded_verify(text, *case, max_err=E,
                                           lane_bin=lane_bin, bin_n=bin_n)
    want = verify.banded_verify(text, *case, max_err=E, lane_bin=lane_bin,
                                bin_n=bin_n)
    torch.cuda.synchronize()
    assert (v.launches, v.stacked_launches) == (before + 1, stacked_before + 1)
    for g, w, name in zip(got, want, ["dist", "begin", "end"]):
        assert torch.equal(g, w), name


def test_flat_step_on_card_equals_cpu(cuda_device):
    """One mesh step (classify, route, flat map) of a small bloom-filtered
    database: the card's MeshMapOut equals the CPU's, and so do the SAMs."""
    from dream_yara_tpu_torch._shared import (FMIndex, InterleavedBloomFilter,
                                              MapperOptions, ReadBatch, SeqStore)
    from dream_yara_tpu_torch.ops.device_index import to_device
    from dream_yara_tpu_torch.parallel.dist_mapper import (fetch_mesh_out,
                                                           pack_batch_blob)
    from dream_yara_tpu_torch.parallel.dream_mesh import (MeshDreamMapper,
                                                          mesh_dream_sam)
    from dream_yara_tpu_torch.pipeline.dis_mapper import DreamIndex

    rng = np.random.default_rng(12)
    genomes = [rng.integers(0, 4, 50_000).astype(np.int8) for _ in range(6)]
    stores = [SeqStore.from_seqs([f"g{b}"], [g]) for b, g in enumerate(genomes)]
    fms = [FMIndex.build(st.text, sample_rate=4) for st in stores]
    ibf = InterleavedBloomFilter.create(6, size_bits=1 << 24, n_hashes=3, k=19)
    for b, g in enumerate(genomes):
        ibf.add_kmers(g, b)
    reads = []
    for i in range(2000):
        g = genomes[i % 6]
        p = int(rng.integers(0, 49_900))
        r = g[p : p + 100].copy()
        r[int(rng.integers(0, 100))] = int(rng.integers(0, 4))
        reads.append(r)
    batch = ReadBatch.from_reads([f"r{i}" for i in range(2000)], reads)
    opts = MapperOptions(error_rate=0.03)
    blob, half = pack_batch_blob(batch.seqs[:2000], batch.lengths, 1, 100)
    outs, sams = [], []
    for dev in (cuda_device, torch.device("cpu")):
        m = MeshDreamMapper(DreamIndex(stores, fms, ibf, "bloom", device=dev), opts)
        step = m._step(half, 100, m._r_cap(half), 300, 3, 33, True, 4.0, 1.25)
        outs.append(fetch_mesh_out(step(m.fmset, m.filter_words,
                                        to_device(blob.view(np.int32), dev)))())
        sams.append(mesh_dream_sam(m, batch))
    for f, a, b in zip(outs[0]._fields, *outs):
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert sams[0] == sams[1]
