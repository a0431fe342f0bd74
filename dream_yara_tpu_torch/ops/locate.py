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

from .._shared import BLOCK
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


def _is_marked(mark_bits: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    w = mark_bits[(rows >> 5).long().clamp(0, mark_bits.shape[0] - 1)]
    return ((w >> (rows & 31)) & 1) > 0


def _start_rows(rows: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    rows = rows.to(torch.int32)
    return rows if valid is None else torch.where(valid, rows, 0)


def _sample_at(mark_bits, rank_ck, sa, rows, steps) -> torch.Tensor:
    """SA value of marked rows: sa[mark rank] + steps, the mark rank being
    the group's checkpoint plus the set bits of its words before the row."""
    g = (rows >> 7).long()
    mark4 = mark_bits.reshape(-1, 4)
    ck = rank_ck[g.clamp(0, rank_ck.shape[0] - 1)]
    words = mark4[g.clamp(0, mark4.shape[0] - 1)].long() & _WORD     # (Q, 4)
    widx = torch.arange(0, 128, 32, device=rows.device, dtype=torch.int64)
    n_bits = ((rows & 127).long()[:, None] - widx[None, :]).clamp(0, 32)
    pc = _popcount32(words & ((1 << n_bits) - 1)).sum(dim=1)
    base = sa[(ck.long() + pc).clamp(0, sa.shape[0] - 1)]
    return (base + steps).to(torch.int32)


def locate_sampled_fused(fused: torch.Tensor, counts: torch.Tensor,
                         mark_bits: torch.Tensor, rank_ck: torch.Tensor,
                         sa: torch.Tensor, rows: torch.Tensor,
                         sample_rate: int,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Text positions of SA rows (Q,) on a sampled index, one fused-row
    fetch per LF step (through the row-gather kernel on a card): the row
    carries the occ checkpoint and the stepped row's own char. Lanes with
    ~valid locate row 0. Returns (Q,) int32."""
    rows = _start_rows(rows, valid)
    steps = torch.zeros_like(rows)
    for _ in range(sample_rate - 1):
        marked = _is_marked(mark_bits, rows)
        r = rows & (BLOCK - 1)
        row = gather_rows(fused, rows >> _LOG2_BLOCK)                    # (Q, 24)
        word = row[:, 6:22].gather(1, (r >> 3).long()[:, None])[:, 0]
        c = (word >> ((r & 7) * 4)) & 7
        lf = counts[c.long().clamp(0, counts.shape[0] - 1)] + rank_fused_rows(row, c, r)
        rows = torch.where(marked, rows, lf)
        steps = torch.where(marked, steps, steps + 1)
    return _sample_at(mark_bits, rank_ck, sa, rows, steps)


def locate_sampled_packed(bwt_blocks: torch.Tensor, occ: torch.Tensor,
                          counts: torch.Tensor, sa_samples: torch.Tensor,
                          mark_bits: torch.Tensor, rank_ck: torch.Tensor,
                          rows: torch.Tensor, sample_rate: int,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """The same locate over the raw layout (int8 BWT blocks and the occ
    table) instead of the fused rows."""
    rows = _start_rows(rows, valid)
    steps = torch.zeros_like(rows)
    for _ in range(sample_rate - 1):
        marked = _is_marked(mark_bits, rows)
        blk = gather_rows(bwt_blocks.view(torch.int32),
                          rows >> _LOG2_BLOCK).view(torch.int8)          # (Q, 128)
        c = blk.gather(1, (rows & (BLOCK - 1)).long()[:, None])[:, 0].to(torch.int32)
        lf = counts[c.long().clamp(0, counts.shape[0] - 1)] + rank(bwt_blocks, occ, c, rows)
        rows = torch.where(marked, rows, lf)
        steps = torch.where(marked, steps, steps + 1)
    return _sample_at(mark_bits, rank_ck, sa_samples, rows, steps)
