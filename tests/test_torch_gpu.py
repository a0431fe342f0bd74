"""Card-only test of the port: the CUDA banded-verify kernel against its plain
PyTorch edition on the same card, exact equality (integer outputs).

Skips where there is no CUDA device. On a machine with a card and without
JAX (tests/conftest.py imports JAX), run it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import edge_case, verify_case
from dream_yara_tpu_torch.ops import banded_verify_cuda, verify

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
