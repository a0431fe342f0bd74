"""The reference's own seed index: exact occurrences of short seeds in a
text. A table of the seeds' first 12 bases picks candidate positions from
one pass of packed 12-mers over the text; each candidate is then compared
whole. Plain NumPy; it builds nothing from the mapper's FM index."""

from __future__ import annotations

import numpy as np

PREFIX = 12
CHUNK = 1 << 24


def pack(seqs: np.ndarray) -> np.ndarray:
    """(Q, k) codes 0-3 -> (Q,) uint64, first character most significant."""
    v = np.zeros(len(seqs), np.uint64)
    for i in range(seqs.shape[1]):
        v = (v << np.uint64(2)) | seqs[:, i].astype(np.uint64)
    return v


def _prefixes(t: np.ndarray, p: int) -> np.ndarray:
    """Packed p-mers (p <= 16) at every start of the 2-bit codes `t`."""
    v = np.zeros(len(t) - p + 1, np.uint32)
    for i in range(p):
        v = (v << np.uint32(2)) | t[i : len(t) - p + 1 + i]
    return v


def occurrences(text: np.ndarray, seeds: np.ndarray):
    """Every exact occurrence of every seed: (seed index, text position)
    int64 arrays. `seeds` is (Q, k), 12 <= k <= 32, codes 0-3 only; a text
    window that holds a code >= 4 never matches."""
    Q, k = seeds.shape
    if Q == 0 or len(text) < k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    qv = pack(seeds)
    uq = np.unique(qv)
    table = np.zeros(1 << (2 * PREFIX), bool)
    table[(uq >> np.uint64(2 * (k - PREFIX))).astype(np.int64)] = True
    n_win = len(text) - k + 1
    cand = []
    for c0 in range(0, n_win, CHUNK):
        c1 = min(n_win, c0 + CHUNK)
        t = (text[c0 : c1 + PREFIX - 1] & 3).astype(np.uint32)
        cand.append(np.flatnonzero(table[_prefixes(t, PREFIX)]) + c0)
    cand = np.concatenate(cand)
    win = text[cand[:, None] + np.arange(k)[None, :]]
    cand = cand[(win < 4).all(1)]
    val = pack(text[cand[:, None] + np.arange(k)[None, :]])
    order = np.argsort(val, kind="stable")
    pos, val = cand[order], val[order]
    lo = np.searchsorted(val, qv, side="left")
    hi = np.searchsorted(val, qv, side="right")
    cnt = hi - lo
    qi = np.repeat(np.arange(Q, dtype=np.int64), cnt)
    starts = np.repeat(lo - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    return qi, pos[np.arange(len(qi)) + starts].astype(np.int64)
