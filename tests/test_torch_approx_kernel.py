"""The host side of the approximate seed-search kernel (csrc/approx_search.cu),
on the CPU: each layout's branch step against the plain edition's own char
derivation, the kernel's algorithm (branch from the exact lane's recorded
interval, stop once the interval is empty) written out in numpy against
the plain edition, the rank-row counts, and the wrapper's argument checks. The kernel itself runs in tests/test_torch_gpu.py.

The cases and the numpy algorithm are in dream_yara_tpu_torch/approx_cases.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dream_yara_tpu_torch.approx_cases import approx_case, approx_search_numpy
from dream_yara_tpu_torch.ops import approx_search as tas
from dream_yara_tpu_torch.ops.approx_search_cuda import MAX_M, kernel
from dream_yara_tpu_torch.ops.device_index import DeviceFM

CPU = torch.device("cpu")
SHAPES = [(32, 1, True), (32, 1, False), (16, 2, False), (9, 2, True),
          (5, 1, True), (1, 1, True)]


def _plain(fm, store, reads, rows, starts, slens, m, budget, indels,
           rank_rows=None):
    d = DeviceFM.from_host(fm, store.text, CPU)
    t = [torch.from_numpy(a) for a in (reads, rows, starts, slens)]
    return tas.seed_search_edits(d.fused, d.counts, d.n, *t, m, budget=budget,
                                 indels=indels, rank_rows=rank_rows)


@pytest.mark.parametrize("m,budget,indels", SHAPES)
def test_branch_step_is_where_the_plain_lanes_leave_the_exact_lane(
        m, budget, indels):
    """For every layout and every window length eff <= m, by the plain
    edition's char derivation over an ACGT window: at every step before
    min(eff - back, lane_len) the lane is active and reads the exact
    lane's index and char; at eff - back, where the lane still runs, it
    reads another; and its length is eff + dlen."""
    kind, p1, a1, p2, a2 = tas._layout_tables(m, budget, indels)
    back, dlen = tas.layout_branch(kind, p1, p2)
    L = m + 2
    read = np.random.default_rng(m).integers(0, 4, L).astype(np.int8)
    tabs = [torch.from_numpy(x)[None, :] for x in (kind, p1, a1, p2, a2)]
    for eff_v in range(1, m + 1):
        eff = torch.tensor([[eff_v]], dtype=torch.int32)
        w_start = torch.tensor([1], dtype=torch.int32)
        lane_len = tas._lane_len(eff, tabs[0])[0].numpy()
        np.testing.assert_array_equal(lane_len, eff_v + dlen)
        lvalid = (p1 < eff_v) & ((kind != 4) | (p2 < eff_v))
        steps = [tas._lane_step(torch.from_numpy(read), torch.zeros((1, 1),
                                dtype=torch.int64), w_start, eff, t, L, *tabs)
                 for t in range(m + 2)]
        idx = np.stack([s[0][0].numpy() for s in steps])      # (T, NL)
        c = np.stack([s[1][0].numpy() for s in steps])
        for l in np.flatnonzero(lvalid):
            t0 = min(eff_v - back[l], lane_len[l])
            assert 0 <= t0 <= eff_v, (eff_v, l)
            for t in range(t0):
                assert t < lane_len[l] and t < eff_v
                assert (idx[t, l], c[t, l]) == (idx[t, 0], c[t, 0]), (eff_v, l, t)
            tb = eff_v - back[l]
            if tb < lane_len[l]:
                assert (tb >= eff_v
                        or (idx[tb, l], c[tb, l]) != (idx[tb, 0], c[tb, 0])), (
                    eff_v, l, tb)


@pytest.mark.parametrize("budget,indels,m,n_text,padding", [
    (1, True, 32, 4000, False), (1, False, 32, 4000, False),
    (2, False, 16, 4000, False), (2, True, 9, 4000, False),
    (1, True, 20, 127 * 32 - 1, False),              # n a multiple of 128
    (1, True, 32, 4000, True)])                      # an all-padding group
def test_branch_and_early_stop_equal_the_plain_edition(budget, indels, m,
                                                        n_text, padding):
    """The kernel's algorithm, in numpy, gives the plain edition's four
    outputs bit for bit (frozen intervals of dead lanes included), and
    fetches fewer rank rows than its lockstep."""
    store, fm, reads, rows, starts, slens = approx_case(
        7 * m + budget, n_text, 24, 2 * m + 16, m, padding)
    assert padding or ((slens == 0).any() and (slens < m).any()
                       and (slens > m).any() and (reads == 4).any())
    if n_text % 128 == 127:
        assert fm.n % 128 == 0
    got = approx_search_numpy(fm, store, reads, rows, starts, slens, m, budget,
                           indels)
    counter = torch.zeros(1, dtype=torch.int64)
    want = _plain(fm, store, reads, rows, starts, slens, m, budget, indels,
                  counter)
    for g, w, name in zip(got, want, ["lo", "hi", "valid", "w_start"]):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    lockstep = tas.lockstep_rank_rows(len(rows), m, budget, indels)
    assert int(counter[0]) == lockstep
    assert got[4] == 0 if padding else 0 < got[4] < lockstep


def _kernel_args(**over):
    """Valid CPU arguments for the kernel wrapper, with some replaced."""
    S, NL = 4, len(tas._layout_tables(8, 1, False)[0])
    args = dict(fused=torch.zeros((3, 24), dtype=torch.int32),
                counts=torch.zeros(7, dtype=torch.int32),
                n=torch.tensor(200, dtype=torch.int32),
                reads=torch.zeros((2, 20), dtype=torch.int8),
                rows=torch.zeros(S, dtype=torch.int32),
                starts=torch.zeros(S, dtype=torch.int32),
                slens=torch.full((S,), 8, dtype=torch.int32), m=8,
                layouts=torch.zeros((7, NL), dtype=torch.int32),
                rank_rows=torch.zeros(1, dtype=torch.int64))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    ({}, "needs CUDA tensors"),
    ({"m": 0}, "window length"),
    ({"m": MAX_M + 1}, "window length"),
    ({"fused": torch.zeros((3, 24), dtype=torch.int64)}, "fused must be"),
    ({"fused": torch.zeros((3, 22), dtype=torch.int32)}, "24"),
    ({"fused": torch.zeros((0, 24), dtype=torch.int32)}, "24"),
    ({"fused": torch.zeros((24, 3), dtype=torch.int32).t()}, "contiguous"),
    ({"n": torch.tensor([200], dtype=torch.int32)}, "n must be"),
    ({"reads": torch.zeros((2, 20), dtype=torch.uint8)}, "reads must be"),
    ({"reads": torch.zeros((2, 0), dtype=torch.int8)}, "must not be empty"),
    ({"rows": torch.zeros(4, dtype=torch.int64)}, "rows must be"),
    ({"starts": torch.zeros(3, dtype=torch.int32)}, "differ in length"),
    ({"slens": torch.zeros((4, 1), dtype=torch.int32)}, "slens must be"),
    ({"counts": torch.zeros(0, dtype=torch.int32)}, "must not be empty"),
    ({"layouts": torch.zeros((5, 25), dtype=torch.int32)}, "tables"),
    ({"rank_rows": torch.zeros(1, dtype=torch.int32)}, "rank_rows must be"),
    ({"rank_rows": torch.zeros(2, dtype=torch.int64)}, "one count"),
    ({"counts": torch.zeros(7, dtype=torch.int32, device="meta")}, "is on meta"),
])
def test_kernel_wrapper_rejects_bad_arguments(over, match):
    """Every check runs before the library is built: none needs a card."""
    before = kernel.launches
    with pytest.raises(ValueError, match=match):
        kernel(**_kernel_args(**over))
    assert kernel.launches == before


def test_device_layouts_hold_the_tables_and_the_branch_steps():
    t = tas.device_layouts(16, 2, False, CPU)
    assert t is tas.device_layouts(16, 2, False, CPU)
    kind, p1, a1, p2, a2 = tas._layout_tables(16, 2, False)
    want = np.stack([kind, p1, a1, p2, a2, *tas.layout_branch(kind, p1, p2)])
    np.testing.assert_array_equal(t.numpy(), want)
    assert t.dtype == torch.int32 and t.is_contiguous()
