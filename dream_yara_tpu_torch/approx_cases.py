"""Seed cases for the approximate seed-search kernel (numpy, from a seeded
generator), and the kernel's algorithm written out in numpy, one seed and
one lane at a time.

The card-only tests hold the kernel to the plain edition
(ops/approx_search.py) bit for bit. The numpy algorithm adds what they
cannot give: the number of rank rows the kernel must fetch (the plain
edition fetches every lane at every trip, so it has no such count), which
the card test of the kernel's counter compares with; and, in the CPU
tests that run without a card, a check that branching from the exact
lane and stopping at an empty interval give the plain edition's outputs.
"""

from __future__ import annotations

import numpy as np

from .index.fmindex import FMIndex
from .io.seqstore import SeqStore
from .ops import approx_search as tas
from .ops.rank import build_fused_rank_rows, decode_fused_row_np


def approx_case(seed: int, n_text: int, S: int, L: int, m: int,
                padding: bool = False):
    """A text with a 200-char segment repeated 12 times (large intervals)
    and a run of N, its index, and S seeds over reads taken from it with
    up to 2 substitutions and a few N: full windows, windows shorter than
    m, empty seeds (all of them with `padding`). Returns (store, fm,
    reads (R2, L) int8, rows, starts, slens (S,) int32)."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 4, 200).astype(np.int8)
    fill = n_text - 12 * len(seg)
    g = np.concatenate([rng.integers(0, 4, fill // 2), np.tile(seg, 12),
                        rng.integers(0, 4, fill - fill // 2)]).astype(np.int8)
    g[fill // 2 - 40 : fill // 2 - 30] = 4
    store = SeqStore.from_seqs(["x"], [g])
    fm = FMIndex.build(store.text)
    R2 = max(1, S // 2)
    reads = np.zeros((R2, L), np.int8)
    for k in range(R2):
        p = int(rng.integers(0, len(g) - L))
        r = g[p : p + L].copy()
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(0, L))
            r[j] = (r[j] + int(rng.integers(1, 4))) % 4 if r[j] < 4 else r[j]
        reads[k] = r
    reads[rng.random(reads.shape) < 0.01] = 4
    rows = rng.integers(0, R2, S).astype(np.int32)
    slens = np.full(S, L // 2, np.int32)
    slens[::7] = rng.integers(1, m + 1, len(slens[::7]))
    slens[3::11] = 0
    if padding:
        slens[:] = 0
    starts = np.where(rng.random(S) < 0.5, 0, L - slens).astype(np.int32)
    return store, fm, reads, rows, starts, slens



def rank_table(fm) -> np.ndarray:
    """(nb, 129, 8): the rank of char c at in-block position r of fused
    row b, as ops/rank.py::rank_fused_rows decodes it (symbols 6 and 7
    have no occ column)."""
    fused = build_fused_rank_rows(fm.bwt_blocks, fm.occ)
    out = np.zeros((fused.shape[0], 129, 8), np.int64)
    for b in range(fused.shape[0]):
        base, chars = decode_fused_row_np(fused[b])
        hits = chars[:, None] == np.arange(8)[None, :]
        out[b, 1:] = np.cumsum(hits, axis=0)
        out[b, :, :6] += base[None, :]
    return out


def approx_search_numpy(fm, store, reads, rows, starts, slens, m, budget, indels):
    """csrc/approx_search.cu's algorithm, one seed and one lane at a time:
    the exact lane's interval before every step, each lane from its branch
    step, stopped once empty. Returns (lo, hi, valid, w_start, rows
    fetched)."""
    ranks = rank_table(fm)
    counts, n = fm.counts, int(fm.n)
    tables = tas._layout_tables(m, budget, indels)
    kind, p1, a1, p2, a2 = tables
    back, dlen = tas.layout_branch(kind, p1, p2)
    S, NL, L = len(rows), len(kind), reads.shape[1]
    lo = np.zeros((S, NL), np.int32)
    hi = np.zeros((S, NL), np.int32)
    valid = np.zeros((S, NL), bool)
    eff_s = np.minimum(slens, m)
    w_start = (starts + slens - eff_s).astype(np.int32)
    fetched = 0

    def step(c, a, b):         # c in 0..4: read chars and edits
        row = lambda i: ranks[min(i >> 7, len(ranks) - 1), i & 127, c]
        return int(counts[c] + row(a)), int(counts[c] + row(b))

    for s in range(S):
        eff = int(eff_s[s])
        if slens[s] <= 0:
            continue
        win = reads[rows[s], np.clip(w_start[s] + np.arange(eff), 0, L - 1)]
        rec = [(0, n)]
        for t in range(eff):
            a, b = rec[-1]
            if a < b:
                a, b = step(int(win[eff - 1 - t]), a, b)
                fetched += 2
            rec.append((a, b))
        for l in range(NL):
            if not (p1[l] < eff and (kind[l] != 4 or p2[l] < eff)):
                continue
            n_t = eff + dlen[l]
            t = max(0, min(eff - back[l], n_t))
            a, b = rec[t]
            while t < n_t and a < b:
                base = eff - 1 - t
                idx = base
                if kind[l] == 2:
                    idx = base if t < eff - 1 - p1[l] else base - 1
                elif kind[l] == 3:
                    idx = base if t < eff - p1[l] else base + 1
                ch = int(win[idx])
                if ch < 4:
                    if kind[l] in (1, 4) and idx == p1[l]:
                        ch = (ch + a1[l]) & 3
                    if kind[l] == 4 and idx == p2[l]:
                        ch = (ch + a2[l]) & 3
                if kind[l] == 3 and t == eff - p1[l]:
                    ch = int(a1[l])
                a, b = step(ch, a, b)
                fetched += 2
                t += 1
            lo[s, l], hi[s, l] = a, max(a, b)
            valid[s, l] = a < b and n_t > 0
    return lo, hi, valid, w_start, fetched
