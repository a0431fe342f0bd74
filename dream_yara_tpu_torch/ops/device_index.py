"""Device-resident FM index of one bin (counterpart of
dream_yara_tpu/ops/device_index.py::DeviceFM): the host index (numpy)
carried onto `device` as torch tensors, with the sampled-SA fields of a
sampled index and the reverse fused rows of a bidirectional one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._shared import FMIndex
from .rank import build_fused_rank_rows


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; a CUDA copy goes through pinned memory
    and does not block the calling thread."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DeviceFM(NamedTuple):
    """FM index + text of one bin on `device` (see index/fmindex.py)."""

    bwt_blocks: torch.Tensor       # (n_blocks, 128) int8
    occ: torch.Tensor              # (n_blocks + 1, SIGMA) int32
    counts: torch.Tensor           # (SIGMA + 1,) int32
    sa: torch.Tensor               # (n,) int32 full SA, or the sampled values
    text: torch.Tensor             # (n,) int8 — verification windows read this
    n: torch.Tensor                # () int32 text length
    pfx_lo: torch.Tensor | None    # (4^q,) int32 q-mer interval table
    pfx_hi: torch.Tensor | None
    fused: torch.Tensor            # (n_blocks + 1, 24) int32 fused rank rows
    # sampled SA (sample_rate > 1): `sa` holds the sampled values in mark
    # order; locate walks LF to a marked row (ops/locate.py)
    sa_mark_bits: torch.Tensor | None = None  # (nw,) uint32 words as int32, nw % 4 == 0
    sa_rank_ck: torch.Tensor | None = None    # (ceil(n/128) + 1,) int32
    # bidirectional index: fused rank rows of the reversed text (its C
    # table equals `counts`), for the search-scheme seed backend
    rfused: torch.Tensor | None = None        # (n_blocks + 1, 24) int32

    @classmethod
    def from_host(cls, fm: FMIndex, text: np.ndarray, device: torch.device,
                  rfused: np.ndarray | None = None) -> "DeviceFM":
        put = lambda a: None if a is None else to_device(np.asarray(a), device)
        sampled = fm.sample_rate > 1
        return cls(
            bwt_blocks=put(fm.bwt_blocks),
            occ=put(fm.occ),
            counts=put(fm.counts),
            sa=put(fm.sa),
            text=put(np.asarray(text, dtype=np.int8)),
            n=put(np.asarray(fm.n, dtype=np.int32)),
            pfx_lo=put(fm.pfx_lo),
            pfx_hi=put(fm.pfx_hi),
            fused=put(build_fused_rank_rows(fm.bwt_blocks, fm.occ)),
            sa_mark_bits=(put(np.asarray(fm.sa_mark_bits, np.uint32).view(np.int32))
                          if sampled else None),
            sa_rank_ck=put(fm.sa_rank_ck) if sampled else None,
            rfused=put(rfused),
        )
