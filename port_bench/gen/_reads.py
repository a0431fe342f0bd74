"""Helpers shared by the read kinds: windows cut from sequences,
substitutions, reverse complements. Vectorised NumPy."""

from __future__ import annotations

import numpy as np

COMP = np.array([3, 2, 1, 0, 4], np.int8)


def cut(seqs: list[np.ndarray], src: np.ndarray, start: np.ndarray,
        length: int) -> np.ndarray:
    """(n, length) windows seqs[src[i]][start[i] : start[i] + length]."""
    out = np.empty((len(src), length), np.int8)
    win = np.arange(length)
    for b in np.unique(src):
        sel = np.flatnonzero(src == b)
        out[sel] = seqs[b][start[sel, None] + win[None, :]]
    return out


def substitute(rng: np.random.Generator, reads: np.ndarray, lo: int,
               hi: int) -> None:
    """Give each read lo..hi substitutions (uniform count; a position may
    be drawn twice), in place; N stays N."""
    n, L = reads.shape
    count = rng.integers(lo, hi + 1, n)
    for s in range(1, hi + 1):
        rows = np.flatnonzero(count >= s)
        cols = rng.integers(0, L, len(rows))
        shift = rng.integers(1, 4, len(rows)).astype(np.int8)
        base = reads[rows, cols]
        reads[rows, cols] = np.where(base < 4, (base + shift) % 4, base)


def revcomp(reads: np.ndarray) -> np.ndarray:
    return COMP[reads][:, ::-1]
