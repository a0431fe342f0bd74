"""Device-resident FM index of one bin (counterpart of
dream_yara_tpu/ops/device_index.py::DeviceFM).

Full-SA layout only: the sampled-SA fields and the reverse rank rows of the
bidirectional index come with their ROADMAP items (Queue 1, items 11 and 12).
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
    sa: torch.Tensor               # (n,) int32 full SA
    text: torch.Tensor             # (n,) int8 — verification windows read this
    n: torch.Tensor                # () int32 text length
    pfx_lo: torch.Tensor | None    # (4^q,) int32 q-mer interval table
    pfx_hi: torch.Tensor | None
    fused: torch.Tensor            # (n_blocks + 1, 24) int32 fused rank rows

    @classmethod
    def from_host(cls, fm: FMIndex, text: np.ndarray,
                  device: torch.device) -> "DeviceFM":
        if fm.sample_rate > 1:
            raise NotImplementedError(
                "sampled-SA indexes are not ported yet (ROADMAP Queue 1 item 11)")
        put = lambda a: to_device(np.asarray(a), device)
        return cls(
            bwt_blocks=put(fm.bwt_blocks),
            occ=put(fm.occ),
            counts=put(fm.counts),
            sa=put(fm.sa),
            text=put(np.asarray(text, dtype=np.int8)),
            n=put(np.asarray(fm.n, dtype=np.int32)),
            pfx_lo=None if fm.pfx_lo is None else put(fm.pfx_lo),
            pfx_hi=None if fm.pfx_hi is None else put(fm.pfx_hi),
            fused=put(build_fused_rank_rows(fm.bwt_blocks, fm.occ)),
        )
