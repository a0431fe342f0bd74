"""Card-only tests of the port: the CUDA banded-verify and row-gather kernels
against their plain PyTorch editions on the same card, exact equality
(integer outputs).

Skips where there is no CUDA device. On a machine with a card and without
JAX (tests/conftest.py imports JAX), run it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import edge_case, verify_case
from dream_yara_tpu_torch.ops import (banded_verify_cuda, row_gather,
                                      row_gather_cuda, verify)

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
