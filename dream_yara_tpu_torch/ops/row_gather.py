"""Row gather, plain PyTorch edition: out[i, :] = table[idx[i], :], with the
indices clamped to [0, nb - 1].

The function of the TPU row-gather kernels (tools/proto_pallas_rank.py
_vmem_kernel and _dma_kernel, tools/proto_probe_dma.py _ring_kernel) and of
csrc/row_gather.cu. CPU tensors take this edition; the entry point every
caller uses is ops/row_gather_cuda.py::gather_rows. JAX gathers clamp or
fill out-of-range indices, torch's raise, so the port clamps explicitly.
"""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (nb, W); idx: (Q,) int32 or int64. Returns (Q, W)."""
    nb = table.shape[0]
    return table.index_select(0, idx.long().clamp(0, nb - 1))
