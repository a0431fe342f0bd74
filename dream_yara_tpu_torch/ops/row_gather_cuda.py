"""The row-gather CUDA kernel (csrc/row_gather.cu): binding and the one entry
point every row fetch of the port goes through — the fused rank rows of
seed search (ops/rank.py) and the IBF block rows of the classifier
(ops/ibf_query.py).

`gather_rows(table, idx)`: a CPU tensor runs the plain edition
(ops/row_gather.py); a CUDA tensor launches the kernel or raises. The
kernel is compiled at first use (ops/nvcc_build.py) and bound with ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from . import row_gather as _plain
from .nvcc_build import NvccKernel


class RowGatherKernel(NvccKernel):
    """Build-once handle of csrc/row_gather.cu, with its launch counter."""

    def __init__(self):
        super().__init__("row_gather.cu")

    def _bind(self, lib):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dy_row_gather.argtypes = [p, ll, i, p, i, ll, p, p]
        lib.dy_row_gather.restype = i

    def __call__(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Launch on the current stream of the tensors' device; returns the
        (Q, W) int32 rows without synchronising."""
        dev = table.device
        if dev.type != "cuda":
            raise ValueError(f"kernel needs CUDA tensors, got {dev}")
        if idx.device != dev:
            raise ValueError(f"idx is on {idx.device}, table on {dev}")
        if table.dtype != torch.int32 or table.dim() != 2:
            raise ValueError(f"table must be a 2-d int32 tensor, got "
                             f"{table.dim()}-d {table.dtype}")
        if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
            raise ValueError(f"idx must be a 1-d int32 or int64 tensor, got "
                             f"{idx.dim()}-d {idx.dtype}")
        if not (table.is_contiguous() and idx.is_contiguous()):
            raise ValueError("table and idx must be contiguous")
        nb, W = table.shape
        if nb == 0:
            raise ValueError("cannot gather from an empty table")
        if (4 * W) % 16 != 0 or table.data_ptr() % 16 != 0:
            raise ValueError(f"table rows must be 16-byte multiples on a "
                             f"16-byte boundary, got {W} int32 words")
        lib = self._load()
        Q = idx.shape[0]
        out = torch.empty((Q, W), dtype=torch.int32, device=dev)
        if Q == 0:
            return out
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.dy_row_gather(table.data_ptr(), nb, 4 * W,
                                    idx.data_ptr(), idx.element_size(), Q,
                                    out.data_ptr(), stream)
        self._launched(err)
        return out


kernel = RowGatherKernel()


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, :] = table[clamp(idx[i], 0, nb - 1), :]: the plain edition for
    CPU tensors, the CUDA kernel for CUDA tensors (no fallback between them)."""
    if table.device.type == "cpu":
        return _plain.gather_rows(table, idx)
    return kernel(table, idx)
