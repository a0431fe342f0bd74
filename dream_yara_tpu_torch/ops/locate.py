"""SA locate for sampled suffix arrays on the device (counterpart of
dream_yara_tpu/ops/locate.py).

With sample rate s, the index keeps the SA values of the marked rows (text
positions divisible by s, and rows whose BWT char is the sentinel) in mark
order, a mark bitmap (uint32 words held as int32, 4 words per 128 rows) and
a mark-rank checkpoint every 128 rows. locate(row) walks LF at most s - 1
times until it stands on a marked row, then reads the sample at the row's
mark rank and adds the steps taken. The walk has a fixed trip count: lanes
that reached a marked row stay put, so it never waits on the device.
"""

from __future__ import annotations

import torch

from ..index.fmindex import BLOCK
from .rank import rank, rank_fused_rows
from .row_gather_cuda import gather_rows

_LOG2_BLOCK = 7
_WORD = 0xFFFFFFFF


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _is_marked(mark4: torch.Tensor, rows: torch.Tensor, gbase=0) -> torch.Tensor:
    """Mark bit of each row; mark4: (groups, 4) mark words, gbase: per-lane
    offset of the lane's bin into the flattened groups."""
    w = _take(mark4, gbase + (rows >> 7).long())                           # (Q, 4)
    word = w.gather(1, ((rows >> 5) & 3).long()[:, None])[:, 0]
    return ((word >> (rows & 31)) & 1) > 0


def _start_rows(rows: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    rows = rows.to(torch.int32)
    return rows if valid is None else torch.where(valid, rows, 0)


def _take(table: torch.Tensor, idx) -> torch.Tensor:
    """table[idx] with idx clamped to the table, as the reference's fetches
    clip their flattened indices."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def _sample_at(mark4, rank_ck, sa, rows, steps, gbase=0, ckbase=0,
               sbase=0) -> torch.Tensor:
    """SA value of marked rows: sa[mark rank] + steps, the mark rank being
    the group's checkpoint plus the set bits of its words before the row.
    mark4: (groups, 4) mark words; gbase/ckbase/sbase: per-lane offsets of
    the lane's bin into the flattened group, checkpoint and sample tables."""
    g = (rows >> 7).long()
    ck = _take(rank_ck, ckbase + g)
    words = _take(mark4, gbase + g).long() & _WORD                       # (Q, 4)
    widx = torch.arange(0, 128, 32, device=rows.device, dtype=torch.int64)
    n_bits = ((rows & 127).long()[:, None] - widx[None, :]).clamp(0, 32)
    pc = _popcount32(words & ((1 << n_bits) - 1)).sum(dim=1)
    base = _take(sa, sbase + ck.long() + pc)
    return (base + steps).to(torch.int32)


def locate_sampled_fused(fused: torch.Tensor, counts: torch.Tensor,
                         mark_bits: torch.Tensor, rank_ck: torch.Tensor,
                         sa: torch.Tensor, rows: torch.Tensor,
                         sample_rate: int,
                         valid: torch.Tensor | None = None,
                         lane_bin: torch.Tensor | None = None) -> torch.Tensor:
    """Text positions of SA rows (Q,) on a sampled index, one fused-row
    fetch per LF step (through the row-gather kernel on a card): the row
    carries the occ checkpoint and the stepped row's own char. Lanes with
    ~valid locate row 0. Returns (Q,) int32.

    With `lane_bin` (Q,), every table is the flat multi-bin step's per-bin
    stack — fused (B, nb1, 24), counts (B, SIGMA + 1), mark_bits (B, nw/4,
    4), rank_ck (B, nck), sa (B, max_sa) — and lane q reads bin
    lane_bin[q] at int64 offsets into the flattened tables."""
    rows = _start_rows(rows, valid)
    steps = torch.zeros_like(rows)
    nsig = counts.shape[-1]
    if lane_bin is None:
        row_base = cbase = gbase = ckbase = sbase = 0
    else:
        lb = lane_bin.long()
        row_base, cbase = lb * fused.shape[1], lb * nsig
        gbase, ckbase, sbase = (lb * mark_bits.shape[1], lb * rank_ck.shape[1],
                                lb * sa.shape[1])
        fused = fused.reshape(-1, fused.shape[-1])
    counts, rank_ck, sa = counts.reshape(-1), rank_ck.reshape(-1), sa.reshape(-1)
    mark4 = mark_bits.reshape(-1, 4)
    for _ in range(sample_rate - 1):
        marked = _is_marked(mark4, rows, gbase)
        r = rows & (BLOCK - 1)
        row = gather_rows(fused, row_base + (rows >> _LOG2_BLOCK))      # (Q, 24)
        word = row[:, 6:22].gather(1, (r >> 3).long()[:, None])[:, 0]
        c = (word >> ((r & 7) * 4)) & 7
        lf = counts[cbase + c.long().clamp(0, nsig - 1)] + rank_fused_rows(row, c, r)
        rows = torch.where(marked, rows, lf)
        steps = torch.where(marked, steps, steps + 1)
    return _sample_at(mark4, rank_ck, sa, rows, steps, gbase, ckbase, sbase)


def locate_sampled_packed(bwt_blocks: torch.Tensor, occ: torch.Tensor,
                          counts: torch.Tensor, sa_samples: torch.Tensor,
                          mark_bits: torch.Tensor, rank_ck: torch.Tensor,
                          rows: torch.Tensor, sample_rate: int,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """The same locate over the raw layout (int8 BWT blocks and the occ
    table) instead of the fused rows."""
    rows = _start_rows(rows, valid)
    steps = torch.zeros_like(rows)
    mark4 = mark_bits.reshape(-1, 4)
    for _ in range(sample_rate - 1):
        marked = _is_marked(mark4, rows)
        blk = gather_rows(bwt_blocks.view(torch.int32),
                          rows >> _LOG2_BLOCK).view(torch.int8)          # (Q, 128)
        c = blk.gather(1, (rows & (BLOCK - 1)).long()[:, None])[:, 0].to(torch.int32)
        lf = counts[c.long().clamp(0, counts.shape[0] - 1)] + rank(bwt_blocks, occ, c, rows)
        rows = torch.where(marked, rows, lf)
        steps = torch.where(marked, steps, steps + 1)
    return _sample_at(mark4, rank_ck, sa_samples, rows, steps)
