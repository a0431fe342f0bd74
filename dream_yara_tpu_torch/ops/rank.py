"""Batched FM rank queries over fused rank rows — the innermost device op of
seed search (counterpart of dream_yara_tpu/ops/rank.py).

A fused row holds one block's occ checkpoint (cols 0..5) and its 128 BWT
chars, 4 bits each, 8 per int32 word, low nibble first (cols 6..21). A rank
query gathers one row and counts the matching chars before its in-block
position. The rows are int32 tensors: torch supports uint32 only partly, so
every shift is followed by a mask.

Chars are counted nibble by nibble inside the 16 words of a row, never
expanded to 128 columns: chars are 3-bit codes (the BWT pad is 7), so bit 3
of every nibble is 0 and a per-nibble add or compare carries into nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from .._shared import BLOCK
from .row_gather_cuda import gather_rows

_LOG2_BLOCK = 7
assert BLOCK == 1 << _LOG2_BLOCK

_NIBBLE_LSB = 0x11111111   # bit 0 of each of the 8 nibbles of a word
_WORD = 0xFFFFFFFF
_SIGMA = 6                 # occ columns of a fused row (A, C, G, T, N, $)


def build_fused_rank_rows(bwt_blocks: np.ndarray, occ: np.ndarray) -> np.ndarray:
    """Host-side: fuse occ checkpoints and 4-bit-packed BWT chars into one
    (n_blocks + 1, 24) int32 row per block (cols 22..23 pad); the last row
    holds the final checkpoint and decodes to char 0."""
    nb = bwt_blocks.shape[0]
    fused = np.zeros((nb + 1, 24), dtype=np.int32)
    fused[: occ.shape[0], :6] = occ[: nb + 1]
    if occ.shape[0] < nb + 1:
        fused[occ.shape[0] :, :6] = occ[-1]
    chars = bwt_blocks.astype(np.uint32).reshape(nb, 16, 8)
    shifts = (np.arange(8, dtype=np.uint32) * 4)[None, None, :]
    words = (chars << shifts).sum(axis=2, dtype=np.uint32)
    fused[:nb, 6:22] = words.astype(np.int32, casting="unsafe")
    return fused


def decode_fused_row_np(row: np.ndarray):
    """Host decode of ONE fused row: (occ base (SIGMA,) int32, chars (128,))."""
    base = row[:6].copy()
    words = row[6:22].astype(np.uint32)
    nib = (np.arange(8, dtype=np.uint32) * 4)[None, :]
    chars = ((words[:, None] >> nib) & 7).reshape(BLOCK)
    return base, chars


def rank(bwt_blocks: torch.Tensor, occ: torch.Tensor, c: torch.Tensor,
         i: torch.Tensor) -> torch.Tensor:
    """Occurrences of c[q] in bwt[0 : i[q]) over the raw layout.

    bwt_blocks: (n_blocks, 128) int8; occ: (n_blocks + 1, SIGMA) int32;
    c, i: (Q,) int32. The block rows (128 bytes, 32 words) come through the
    row gather; the occ rows (6 words) by indexing."""
    b = i.long() >> _LOG2_BLOCK
    r = i & (BLOCK - 1)
    nb = bwt_blocks.shape[0]
    rows = gather_rows(bwt_blocks.view(torch.int32), b).view(torch.int8)
    base = occ[b.clamp(0, occ.shape[0] - 1)].gather(
        1, c.long().clamp(0, occ.shape[1] - 1)[:, None])[:, 0]
    pos = torch.arange(BLOCK, device=c.device, dtype=torch.int32)
    within = ((rows == c[:, None].to(torch.int8))
              & (pos[None, :] < r[:, None])).sum(dim=1, dtype=torch.int32)
    # a query at i = n on a 128-aligned text has no block row to scan
    return base + torch.where(b < nb, within, 0)


def rank_fused(fused: torch.Tensor, c: torch.Tensor, i: torch.Tensor,
               row_base: torch.Tensor | None = None) -> torch.Tensor:
    """Occurrences of symbol c[q] in bwt[0 : i[q]) for each query q.

    fused: (n_blocks + 1, 24) int32; c, i: (Q,) int32 with 0 <= i <= n.
    `row_base` (Q,) int64: per-query row offset into a flattened stack of
    several bins' rows (the flat multi-bin step). Returns (Q,) int32. The
    rows are fetched by the row-gather kernel on a card
    (ops/row_gather_cuda.py)."""
    r = i & (BLOCK - 1)
    b = i >> _LOG2_BLOCK
    if row_base is not None:
        b = row_base + b
    return rank_fused_rows(gather_rows(fused, b), c, r)


def _words(row: torch.Tensor) -> torch.Tensor:
    """The 16 char words of fused rows as int64 holding uint32: (Q, 16)."""
    return row[:, 6:22].long() & _WORD


def _before(r: torch.Tensor) -> torch.Tensor:
    """(Q, 16) nibble-LSB mask of the chars before in-block position r."""
    k0 = torch.arange(0, BLOCK, 8, device=r.device, dtype=torch.int64)
    n_valid = (r.long()[:, None] - k0[None, :]).clamp(0, 8)
    return ((torch.ones_like(n_valid) << (4 * n_valid)) - 1) & _NIBBLE_LSB


def _count(flags: torch.Tensor) -> torch.Tensor:
    """Sum of nibble-LSB flags (Q, 16) -> (Q,) int32: a multiply gathers a
    word's 8 flags into its top nibble (at most 8, so nothing carries)."""
    return (((flags * _NIBBLE_LSB) >> 28) & 0xF).sum(dim=1).to(torch.int32)


def _eq_flags(words: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nibble-LSB flags of the chars equal to c (Q,): XOR with c in every
    nibble zeroes the matches, then a nibble's three bits OR into bit 0."""
    x = words ^ ((c.long() & 7) * _NIBBLE_LSB)[:, None]
    return ~(x | (x >> 1) | (x >> 2)) & _NIBBLE_LSB


def _lt_flags(words: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nibble-LSB flags of the chars smaller than c (Q,), c in 0..8: adding
    8 - c to a nibble sets its bit 3 exactly when the char is >= c."""
    y = words + ((8 - c.long().clamp(0, 8)) * _NIBBLE_LSB)[:, None]
    return ~(y >> 3) & _NIBBLE_LSB


def rank_fused_rows(row: torch.Tensor, c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Decode fused rank rows: row (Q, 24), symbol c (Q,), in-block pos r (Q,).

    Symbols outside 0..5 have no occ column (base 0); symbols outside 0..7
    match no char."""
    c = c.long()
    base = row[:, :6].gather(1, c.clamp(0, 5)[:, None])[:, 0]
    base = torch.where((c >= 0) & (c < 6), base, 0)
    hits = _eq_flags(_words(row), c) & _before(r)
    hits = torch.where(((c >= 0) & (c < 8))[:, None], hits, 0)
    return base + _count(hits)


def rank_lt_fused_rows(row: torch.Tensor, c: torch.Tensor, r: torch.Tensor):
    """(rank of c, occurrences of all symbols < c) at in-block pos r, from
    the same fused rows: row (Q, 24), c (Q,) in 0..5, r (Q,). The BWT pad
    (7) counts for neither."""
    c = c.long()
    words, before = _words(row), _before(r)
    col = torch.arange(_SIGMA, device=row.device)[None, :]
    occ = row[:, :_SIGMA]
    base_c = torch.where(col == c[:, None], occ, 0).sum(dim=1, dtype=torch.int32)
    base_lt = torch.where(col < c[:, None], occ, 0).sum(dim=1, dtype=torch.int32)
    return (base_c + _count(_eq_flags(words, c) & before),
            base_lt + _count(_lt_flags(words, c) & before))


def rank_all_fused_rows(row: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """occ counts of ALL six symbols at in-block pos r: row (Q, 24) -> (Q, 6)
    int32, six nibble compare-counts over the one fetched row."""
    words, before = _words(row), _before(r)
    within = [_count(_eq_flags(words, torch.full_like(r, s, dtype=torch.int64))
                     & before) for s in range(_SIGMA)]
    return row[:, :_SIGMA] + torch.stack(within, dim=1)
