"""Batched FM rank queries over fused rank rows — the innermost device op of
seed search (counterpart of dream_yara_tpu/ops/rank.py).

A fused row holds one block's occ checkpoint (cols 0..5) and its 128 BWT
chars, 4 bits each, 8 per int32 word, low nibble first (cols 6..21). A rank
query gathers one row and counts the matching chars before its in-block
position. The rows are int32 tensors: torch supports uint32 only partly, so
every shift is followed by a mask.
"""

from __future__ import annotations

import numpy as np
import torch

from .._shared import BLOCK

_LOG2_BLOCK = 7
assert BLOCK == 1 << _LOG2_BLOCK

_NIBBLE_LSB = 0x11111111   # bit 0 of each of the 8 nibbles of a word
_WORD = 0xFFFFFFFF


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


def rank_fused(fused: torch.Tensor, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Occurrences of symbol c[q] in bwt[0 : i[q]) for each query q.

    fused: (n_blocks + 1, 24) int32; c, i: (Q,) int32 with 0 <= i <= n.
    Returns (Q,) int32."""
    b = (i >> _LOG2_BLOCK).long()
    r = i & (BLOCK - 1)
    return rank_fused_rows(fused[b], c, r)


def rank_fused_rows(row: torch.Tensor, c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Decode fused rank rows: row (Q, 24), symbol c (Q,), in-block pos r (Q,).

    Counts matching nibbles word by word instead of expanding 128 chars:
    XOR with c repeated in every nibble zeroes the matching nibbles, a
    nibble's three value bits are OR-ed into its bit 0, and a multiply sums
    the 8 nibble flags into the top nibble. Chars are 3-bit codes (< 8), so
    bit 3 of every nibble is 0 and nothing carries between nibbles."""
    c = c.long()
    base = row[:, :6].gather(1, c.clamp(0, 5)[:, None])[:, 0]
    base = torch.where((c >= 0) & (c < 6), base, 0)              # no occ column
    words = row[:, 6:22].long() & _WORD                          # (Q, 16)
    x = words ^ ((c & 7) * _NIBBLE_LSB)[:, None]
    nonzero = (x | (x >> 1) | (x >> 2)) & _NIBBLE_LSB
    k0 = torch.arange(0, BLOCK, 8, device=row.device, dtype=torch.int64)
    n_valid = (r.long()[:, None] - k0[None, :]).clamp(0, 8)       # chars before r
    n_valid = torch.where(((c >= 0) & (c < 8))[:, None], n_valid, 0)
    valid = (torch.ones_like(n_valid) << (4 * n_valid)) - 1
    hits = ~nonzero & _NIBBLE_LSB & valid
    within = ((hits * _NIBBLE_LSB) >> 28) & 0xF
    return base + within.sum(dim=1).to(torch.int32)
