"""Device-resident FM indexes (counterpart of
dream_yara_tpu/ops/device_index.py): `DeviceFM`, the host index of one bin
(numpy) carried onto `device` as torch tensors, with the sampled-SA fields
of a sampled index and the reverse fused rows of a bidirectional one; and
`DeviceFMSet`, B bins stacked with padding to the largest, the state the
flat multi-bin step (pipeline/flat_step.py) reads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._shared import BLOCK, BWT_PAD, FMIndex
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


class DeviceFMSet(NamedTuple):
    """B bins stacked with padding to the largest bin, on one device.

    Padding, as in the reference: BWT blocks with BWT_PAD, occ rows and
    fused rows repeat the last row (rank past the text end is constant),
    the SA with 0 and the text with BWT_PAD; `n` carries each bin's true
    length, so searches stay exact. Every bin shares one prefix-table depth
    q (the smallest over the bins; a bin built at another q is rebuilt) and
    one SA sample rate (the layout is the full SA unless all bins share a
    rate > 1). Mark bits are grouped (B, nw/4, 4) as uint32 bits in int32."""

    bwt_blocks: torch.Tensor              # (B, max_blocks, 128) int8 (1 block if lean)
    occ: torch.Tensor                     # (B, max_blocks + 1, SIGMA) int32
    counts: torch.Tensor                  # (B, SIGMA + 1) int32
    sa: torch.Tensor                      # (B, max_sa) int32, full or sampled values
    text: torch.Tensor                    # (B, max_n) int8
    n: torch.Tensor                       # (B,) int32
    pfx_lo: torch.Tensor | None = None    # (B, 4^q) int32
    pfx_hi: torch.Tensor | None = None
    fused: torch.Tensor | None = None     # (B, max_blocks + 1, 24) int32
    sa_mark_bits: torch.Tensor | None = None  # (B, nw/4, 4) int32
    sa_rank_ck: torch.Tensor | None = None    # (B, nck) int32

    @property
    def n_bins(self) -> int:
        return self.bwt_blocks.shape[0]

    @property
    def prefix_q(self) -> int:
        if self.pfx_lo is None:
            return 0
        q = 0
        while 4 ** q < self.pfx_lo.shape[1]:
            q += 1
        return q

    @classmethod
    def from_host(cls, fms: list[FMIndex], texts: list[np.ndarray],
                  device: torch.device, pad_bins_to: int | None = None,
                  lean: bool = False) -> "DeviceFMSet":
        arrs = cls.build_np(fms, texts, pad_bins_to, lean)
        if arrs["sa_mark_bits"] is not None:
            arrs["sa_mark_bits"] = arrs["sa_mark_bits"].view(np.int32)
        return cls(**{k: None if v is None else to_device(v, device)
                      for k, v in arrs.items()})

    @classmethod
    def build_np(cls, fms: list[FMIndex], texts: list[np.ndarray],
                 pad_bins_to: int | None = None, lean: bool = False) -> dict:
        """The stacked fields as numpy arrays, laid out as the reference's
        build_np (mark bits as uint32). lean=True keeps 1-block placeholders
        for bwt_blocks/occ, which the flat step never reads. Like the
        reference, a bin whose prefix table has another q gets its table
        rebuilt at the common q on its host FMIndex."""
        B = len(fms)
        if B == 0:
            raise ValueError("a device set needs at least one bin")
        max_n = max(fm.n for fm in fms)
        max_blocks = (max_n + BLOCK - 1) // BLOCK
        Bp = pad_bins_to or B
        blk_keep = 1 if lean else max_blocks
        bwt = np.full((Bp, blk_keep, BLOCK), BWT_PAD, dtype=np.int8)
        occ = np.zeros((Bp, blk_keep + 1, fms[0].occ.shape[1]), dtype=np.int32)
        counts = np.zeros((Bp, fms[0].counts.shape[0]), dtype=np.int32)
        n = np.zeros(Bp, dtype=np.int32)
        text = np.full((Bp, max_n), BWT_PAD, dtype=np.int8)
        rates = {fm.sample_rate for fm in fms}
        rate = rates.pop() if len(rates) == 1 else 1
        sampled = rate > 1
        max_sa = (max_n + rate - 1) // rate if sampled else max_n
        sa = np.zeros((Bp, max_sa), dtype=np.int32)
        qs = [fm.prefix_q for fm in fms]
        q = min(qs) if all(q > 0 for q in qs) else 0
        pfx_lo = pfx_hi = None
        if q > 0:
            pfx_lo = np.zeros((Bp, 4 ** q), dtype=np.int32)
            pfx_hi = np.zeros((Bp, 4 ** q), dtype=np.int32)
        fused = np.zeros((Bp, max_blocks + 1, 24), dtype=np.int32)
        for b, (fm, t) in enumerate(zip(fms, texts)):
            nb = fm.bwt_blocks.shape[0]
            if not lean:
                bwt[b, :nb] = fm.bwt_blocks
                occ[b, : nb + 1] = fm.occ
                occ[b, nb + 1 :] = fm.occ[-1]
            counts[b] = fm.counts
            sa[b, : len(fm.sa)] = fm.sa
            text[b, : fm.n] = t
            n[b] = fm.n
            fb = build_fused_rank_rows(fm.bwt_blocks, fm.occ)
            fused[b, : fb.shape[0]] = fb
            fused[b, fb.shape[0] :] = fb[-1]
            if q > 0:
                if fm.prefix_q != q:
                    fm.build_prefix_table(t, q)
                pfx_lo[b] = fm.pfx_lo
                pfx_hi[b] = fm.pfx_hi
        mark_bits = rank_ck = None
        if sampled:
            nw = ((max_n + 31) // 32 + 3) // 4 * 4
            nck = (max_n + 127) // 128 + 1
            mark_bits = np.zeros((Bp, nw // 4, 4), dtype=np.uint32)
            rank_ck = np.zeros((Bp, nck), dtype=np.int32)
            for b, fm in enumerate(fms):
                mark_bits[b].reshape(-1)[: len(fm.sa_mark_bits)] = fm.sa_mark_bits
                rank_ck[b, : len(fm.sa_rank_ck)] = fm.sa_rank_ck
                rank_ck[b, len(fm.sa_rank_ck) :] = fm.sa_rank_ck[-1]
        return dict(bwt_blocks=bwt, occ=occ, counts=counts, sa=sa, text=text,
                    n=n, pfx_lo=pfx_lo, pfx_hi=pfx_hi, fused=fused,
                    sa_mark_bits=mark_bits, sa_rank_ck=rank_ck)

    def bin(self, b: int) -> DeviceFM:
        """Bin b as a DeviceFM view of the stacked tensors (no copy); its
        text and SA keep the stack's padding, its `n` is the true length."""
        g = lambda f: None if getattr(self, f) is None else getattr(self, f)[b]
        mb = g("sa_mark_bits")
        return DeviceFM(bwt_blocks=self.bwt_blocks[b], occ=self.occ[b],
                        counts=self.counts[b], sa=self.sa[b],
                        text=self.text[b], n=self.n[b],
                        pfx_lo=g("pfx_lo"), pfx_hi=g("pfx_hi"),
                        fused=self.fused[b],
                        sa_mark_bits=None if mb is None else mb.reshape(-1),
                        sa_rank_ck=g("sa_rank_ck"))
