"""Port parity for the row gather (ops/row_gather.py, the plain edition of
csrc/row_gather.cu): against jnp.take, and against the three TPU row-gather
kernels run in Pallas interpret mode, as their own CPU checks run them
(tools/proto_pallas_rank.py, tools/proto_probe_dma.py). Exact equality:
the outputs are integers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dream_yara_tpu_torch.ops import row_gather, row_gather_cuda
from tools import proto_pallas_rank, proto_probe_dma

torch.set_num_threads(2)


def _table(rng, nb, W):
    return rng.integers(-2**31, 2**31, size=(nb, W), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("W", [24, 64, 128])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_plain_gather_equals_take(W, idx_dtype):
    """Edge and out-of-range indices clamp, as jnp.take(mode="clip")."""
    rng = np.random.default_rng(W)
    nb = 1000
    tab = _table(rng, nb, W)
    idx = rng.integers(0, nb, 5000).astype(idx_dtype)
    idx[:8] = [0, nb - 1, -1, -77, nb, nb + 12345, 0, nb - 1]
    got = row_gather.gather_rows(torch.from_numpy(tab), torch.from_numpy(idx))
    want = np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(idx), axis=0,
                               mode="clip"))
    assert got.dtype == torch.int32 and got.shape == (len(idx), W)
    np.testing.assert_array_equal(got.numpy(), want)


def _bind_proto_pallas_rank(monkeypatch):
    """proto_pallas_rank binds its jax/pallas globals inside main()."""
    for name, mod in (("jax", jax), ("jnp", jnp), ("pl", pl), ("pltpu", pltpu)):
        monkeypatch.setattr(proto_pallas_rank, name, mod, raising=False)


def test_plain_equals_pallas_vmem_and_dma_kernels(monkeypatch):
    """_vmem_kernel ((nb, 1, 24) table in VMEM) and _dma_kernel ((nb, 128)
    rows by DMA waves), interpret mode, two tiles of queries."""
    _bind_proto_pallas_rank(monkeypatch)
    rng = np.random.default_rng(0)
    nb, Q = 3000, 2 * proto_pallas_rank.TILE_Q
    tab = _table(rng, nb, 24)
    tab128 = np.zeros((nb, 128), np.int32)
    tab128[:, :24] = tab
    idx = rng.integers(0, nb, Q).astype(np.int32)
    idx[:2] = [0, nb - 1]
    idx2 = jnp.asarray(idx.reshape(-1, 1, proto_pallas_rank.TILE_Q))
    want = row_gather.gather_rows(torch.from_numpy(tab), torch.from_numpy(idx))
    vmem = proto_pallas_rank.gather_rows_vmem(
        jnp.asarray(tab.reshape(nb, 1, 24)), idx2, interpret=True)
    np.testing.assert_array_equal(np.asarray(vmem), want.numpy())
    want128 = row_gather.gather_rows(torch.from_numpy(tab128),
                                     torch.from_numpy(idx))
    dma = proto_pallas_rank.gather_rows_dma(jnp.asarray(tab128), idx2,
                                            interpret=True)
    np.testing.assert_array_equal(np.asarray(dma), want128.numpy())


def test_plain_equals_pallas_ring_kernel():
    """_ring_kernel: (n_blocks, 128) uint32 rows with 8 DMAs in flight,
    interpret mode; the port holds the same bits as int32."""
    rng = np.random.default_rng(1)
    n_blocks, Q = 2048, 2 * proto_probe_dma.TILE_Q
    tab = rng.integers(0, 1 << 32, (n_blocks, 128), dtype=np.uint32)
    idx = rng.integers(0, n_blocks, Q).astype(np.int32)
    idx[:2] = [0, n_blocks - 1]
    ring = proto_probe_dma.gather_rows_ring(
        jnp.asarray(tab), jnp.asarray(idx.reshape(-1, 1, proto_probe_dma.TILE_Q)),
        nbuf=8, interpret=True)
    got = row_gather.gather_rows(torch.from_numpy(tab.view(np.int32)),
                                 torch.from_numpy(idx))
    np.testing.assert_array_equal(np.asarray(ring).view(np.int32), got.numpy())


def test_entry_point_routes_cpu_tensors_to_plain_edition():
    rng = np.random.default_rng(2)
    tab = torch.from_numpy(_table(rng, 50, 64))
    idx = torch.from_numpy(rng.integers(-5, 60, 200).astype(np.int64))
    before = row_gather_cuda.kernel.launches
    got = row_gather_cuda.gather_rows(tab, idx)
    assert torch.equal(got, row_gather.gather_rows(tab, idx))
    assert row_gather_cuda.kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        row_gather_cuda.kernel(tab, idx)
