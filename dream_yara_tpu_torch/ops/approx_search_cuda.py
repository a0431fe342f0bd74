"""The approximate seed-search CUDA kernel (csrc/approx_search.cu): binding
and argument checks. `ops/approx_search.py::seed_search_edits` launches it
for CUDA tensors; CPU tensors take the plain edition there.

The kernel is compiled at first use (ops/nvcc_build.py) and bound with
ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from .nvcc_build import NvccKernel

MAX_M = 4096          # csrc/approx_search.cu's longest matched window
TABLES = 7            # layout tables: kind, p1, a1, p2, a2, back, dlen


class ApproxSearchKernel(NvccKernel):
    """Build-once handle of csrc/approx_search.cu, with its launch counter."""

    def __init__(self):
        super().__init__("approx_search.cu")

    def _bind(self, lib):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dy_approx_search.argtypes = [p, ll, p, i, p, p, i, p, p, p, ll, i,
                                         p, i, p, p, p, p, p, p]
        lib.dy_approx_search.restype = i

    def __call__(self, fused, counts, n, reads, rows, starts, slens, m: int,
                 layouts, rank_rows=None):
        """Launch on the current stream of the tensors' device; returns
        (lo, hi, valid, w_start) without synchronising. `layouts`: the
        (7, NL) int32 tables; `rank_rows`: a one-element int64 tensor the
        rank rows fetched are added to, or None."""
        m = int(m)
        if not 1 <= m <= MAX_M:
            raise ValueError(f"window length must be in 1..{MAX_M}, got {m}")
        checks = [("fused", fused, torch.int32, 2), ("counts", counts, torch.int32, 1),
                  ("n", n, torch.int32, 0), ("reads", reads, torch.int8, 2),
                  ("rows", rows, torch.int32, 1), ("starts", starts, torch.int32, 1),
                  ("slens", slens, torch.int32, 1),
                  ("layouts", layouts, torch.int32, 2)]
        if rank_rows is not None:
            checks.append(("rank_rows", rank_rows, torch.int64, 1))
        for name, t, dtype, ndim in checks:
            if t.dtype != dtype or t.dim() != ndim:
                raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, "
                                 f"got {t.dim()}-d {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if fused.shape[1] != 24 or fused.shape[0] == 0:
            raise ValueError(f"fused must hold (n_blocks + 1, 24) rows, got "
                             f"{tuple(fused.shape)}")
        S = rows.shape[0]
        if starts.shape[0] != S or slens.shape[0] != S:
            raise ValueError("rows, starts and slens differ in length")
        if counts.shape[0] == 0 or reads.shape[1] == 0:
            raise ValueError("counts and the reads' rows must not be empty")
        if layouts.shape[0] != TABLES or layouts.shape[1] == 0:
            raise ValueError(f"layouts must be ({TABLES}, NL) tables, got "
                             f"{tuple(layouts.shape)}")
        if rank_rows is not None and rank_rows.shape[0] != 1:
            raise ValueError("rank_rows must hold one count")
        dev = rows.device
        for name, t, *_ in checks:
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, rows on {dev}")
        if dev.type != "cuda":
            raise ValueError(f"kernel needs CUDA tensors, got {dev}")
        if fused.data_ptr() % 16 != 0:
            raise ValueError("fused rows must start on a 16-byte boundary")
        lib = self._load()
        NL = layouts.shape[1]
        lo = torch.empty((S, NL), dtype=torch.int32, device=dev)
        hi = torch.empty_like(lo)
        valid = torch.empty((S, NL), dtype=torch.bool, device=dev)
        w_start = torch.empty(S, dtype=torch.int32, device=dev)
        if S == 0:
            return lo, hi, valid, w_start
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.dy_approx_search(
                fused.data_ptr(), fused.shape[0], counts.data_ptr(),
                counts.shape[0], n.data_ptr(), reads.data_ptr(), reads.shape[1],
                rows.data_ptr(), starts.data_ptr(), slens.data_ptr(), S, m,
                layouts.data_ptr(), NL, lo.data_ptr(), hi.data_ptr(),
                valid.data_ptr(), w_start.data_ptr(),
                None if rank_rows is None else rank_rows.data_ptr(), stream)
        self._launched(err)
        return lo, hi, valid, w_start


kernel = ApproxSearchKernel()
