"""Port parity: the plain PyTorch banded_verify (the CUDA kernel's reference
and CPU path) against the JAX XLA edition and the Pallas kernel in interpret
mode. All outputs are integers: the tolerance is exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dream_yara_tpu.ops.pallas_verify import banded_verify_pallas
from dream_yara_tpu.ops.verify import banded_verify as jax_banded_verify
from dream_yara_tpu_torch.ops import banded_verify_cuda
from dream_yara_tpu_torch.ops.verify import INF, banded_verify
from tests.conftest import mutate, random_text

torch.set_num_threads(2)


def _case(rng, n=5000, C=600, L=80, read_len=70):
    """The inputs of tests/test_pallas.py: reads cut at random anchors with
    a few substitutions and indels."""
    text = random_text(rng, n)
    text[-1] = 5
    anchors = rng.integers(0, n - 100, C).astype(np.int32)
    reads = np.full((C, L), 4, np.int8)
    lens = np.zeros(C, np.int32)
    for i in range(C):
        r = mutate(rng, text[anchors[i] : anchors[i] + read_len].copy(),
                   n_sub=int(rng.integers(0, 3)),
                   n_ins=int(rng.integers(0, 2)),
                   n_del=int(rng.integers(0, 2)))
        reads[i, : len(r)] = r
        lens[i] = len(r)
    return text, anchors, reads, np.arange(C, dtype=np.int32), lens


def _edge_lanes(text, anchors, reads, lens):
    """Anchors at 0, near the text end and negative; length-0 lanes; N and
    sentinel codes in the text."""
    n = len(text)
    anchors[:6] = [0, 1, n - 10, -2, -1, n - 1]
    lens[6:9] = 0
    text[100:110] = 4
    text[2000] = 5
    anchors[9:12] = [95, 1990, 2003]


def _run_all(text, anchors, reads, rows, lens, E, pallas=True):
    targs = [torch.from_numpy(a) for a in (text, anchors, reads, rows, lens)]
    got = banded_verify(*targs, max_err=E)
    jargs = [jnp.asarray(a) for a in (text, anchors, reads, rows, lens)]
    want = [jax_banded_verify(*jargs, max_err=E)]
    if pallas:
        want.append(banded_verify_pallas(*jargs, max_err=E, interpret=True))
    for w in want:
        for x, y, name in zip(got, w, ["dist", "beg", "end"]):
            assert x.dtype == torch.int32
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
    return got


@pytest.mark.parametrize("E", [1, 3, 12])
def test_plain_verify_equals_jax_and_pallas(E):
    rng = np.random.default_rng(100 + E)
    text, anchors, reads, rows, lens = _case(rng)
    _edge_lanes(text, anchors, reads, lens)
    dist, beg, end = _run_all(text, anchors, reads, rows, lens, E)
    assert (dist[6:9] == INF).all() and (beg[6:9] == 0).all() and (end[6:9] == 0).all()
    # the planted reads mostly verify within the band
    assert int((dist <= 4).sum()) > len(dist) // 2


def test_plain_verify_shuffled_rows_and_noise():
    """Candidates point at arbitrary read rows (not lane == row), and some
    reads are random noise that leaves the band."""
    rng = np.random.default_rng(7)
    text, anchors, reads, _, lens = _case(rng, C=300)
    reads[::7] = rng.integers(0, 4, (len(reads[::7]), reads.shape[1]))
    rows = rng.integers(0, reads.shape[0], 300).astype(np.int32)
    lens = lens[rows]
    _run_all(text, anchors, reads, rows, lens, 3, pallas=False)


def test_entry_point_routes_cpu_tensors_to_plain_edition():
    rng = np.random.default_rng(8)
    text, anchors, reads, rows, lens = _case(rng, C=64)
    targs = [torch.from_numpy(a) for a in (text, anchors, reads, rows, lens)]
    before = banded_verify_cuda.kernel.launches
    got = banded_verify_cuda.banded_verify(*targs, max_err=3)
    want = banded_verify(*targs, max_err=3)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert banded_verify_cuda.kernel.launches == before


def test_kernel_wrapper_rejects_cpu_tensors_and_wide_bands():
    rng = np.random.default_rng(9)
    targs = [torch.from_numpy(a) for a in _case(rng, C=8)]
    with pytest.raises(ValueError, match="CUDA"):
        banded_verify_cuda.kernel(*targs, max_err=3)
    with pytest.raises(ValueError, match="E <= 31"):
        banded_verify_cuda.kernel(*targs, max_err=32)
