"""Paired-end selection and mate rescue.

Reference analogs: src/mapper_selector.h PairsSelector (library-consistent
combo selection), src/mapper_verifier.h AnchorsVerifier (mate rescue by banded
verification inside the insert window) [U]; SURVEY.md §3.5.

Contract (docs/OUTPUT_CONTRACT.md): FR orientation only. A combo
(m1 fwd, m2 rc) is proper iff same contig, begin1 <= end2 and
tlen = end2 - begin1 in [ll-ld, ll+ld]; symmetrically for (m1 rc, m2 fwd) with
tlen = end1 - begin2. The selected combo minimizes
(d1+d2, begin1, begin2, strand1) — deterministic. Pairing selects primaries
and flags; it never removes strata matches.

Both stages are fully vectorized NumPy (no per-read Python loops): combos are
materialized as flat index arrays via cumulative-offset arithmetic, and the
per-pair argmin is one lexsort + first-occurrence pass. Anchors stay int64
GLOBAL coordinates throughout — callers convert to bin-local int32 only after
subtracting the bin start (databases beyond 2^31 bp would otherwise wrap).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .matches import Matches, Ranked


@dataclass
class PairInfo:
    """Per-read pairing outcome (index into ranked.matches rows or -1)."""

    primary_idx: np.ndarray   # (n_reads,) int64 — chosen primary match row
    proper: np.ndarray        # (n_reads,) bool
    tlen: np.ndarray          # (n_reads,) int64 signed template length


def _groups(m: Matches, n_reads: int):
    starts = np.searchsorted(m.read_id, np.arange(n_reads), side="left")
    ends = np.searchsorted(m.read_id, np.arange(n_reads), side="right")
    return starts, ends


def _flat_products(cnt_a: np.ndarray, cnt_b: np.ndarray):
    """Index arrays enumerating the cross product of per-group counts.

    Returns (group_id, ka, kb) flat arrays with len = sum(cnt_a * cnt_b):
    group g contributes all (ka, kb) in [0, cnt_a[g]) x [0, cnt_b[g]).
    """
    n_c = (cnt_a * cnt_b).astype(np.int64)
    total = int(n_c.sum())
    group_id = np.repeat(np.arange(len(n_c), dtype=np.int64), n_c)
    off = np.zeros(len(n_c), dtype=np.int64)
    np.cumsum(n_c[:-1], out=off[1:] if len(n_c) > 1 else off[1:])
    k = np.arange(total, dtype=np.int64) - off[group_id]
    cb = cnt_b[group_id]
    return group_id, k // cb, k % cb


def select_pairs(ranked: Ranked, n_reads: int, contigs, library_length: int,
                 library_deviation: int) -> PairInfo:
    """Pick library-consistent primary combos. Reads [0,h) pair with [h,2h)."""
    m = ranked.matches
    h = n_reads // 2
    starts, ends = _groups(m, n_reads)
    cid = contigs.contig_of(m.begin) if len(m) else np.zeros(0, dtype=np.int64)

    primary_idx = np.full(n_reads, -1, dtype=np.int64)
    proper = np.zeros(n_reads, dtype=bool)
    tlen = np.zeros(n_reads, dtype=np.int64)

    # default primaries: first (canonical-best) match of each group
    has = ends > starts
    primary_idx[has] = starts[has]

    g1 = (ends[:h] - starts[:h]).astype(np.int64)
    g2 = (ends[h:] - starts[h:]).astype(np.int64)
    if len(m) == 0 or int((g1 * g2).sum()) == 0:
        return PairInfo(primary_idx=primary_idx, proper=proper, tlen=tlen)

    pid, k1, k2 = _flat_products(g1, g2)
    i = starts[:h][pid] + k1          # match row of mate 1
    j = starts[h:][pid] + k2          # match row of mate 2

    s_i = m.strand[i].astype(np.int64)
    fr = s_i == 0
    t = np.where(fr, m.end[j] - m.begin[i], m.end[i] - m.begin[j])
    valid = ((cid[i] == cid[j]) & (s_i != m.strand[j])
             & (t >= library_length - library_deviation)
             & (t <= library_length + library_deviation))

    # per-pair argmin of (d1+d2, begin1, begin2, strand1) over valid combos:
    # one lexsort (major key last) + first-occurrence-per-pair scan
    d = (m.dist[i] + m.dist[j]).astype(np.int64)
    order = np.lexsort((s_i, m.begin[j], m.begin[i], d, ~valid, pid))
    first = np.ones(len(order), dtype=bool)
    spid = pid[order]
    first[1:] = spid[1:] != spid[:-1]
    win = order[first]
    win = win[valid[win]]             # pairs whose best combo is valid

    r1 = pid[win]
    r2 = r1 + h
    primary_idx[r1] = i[win]
    primary_idx[r2] = j[win]
    proper[r1] = proper[r2] = True
    tw = t[win]
    signed = np.where(m.begin[i[win]] <= m.begin[j[win]], tw, -tw)
    tlen[r1] = signed
    tlen[r2] = -signed
    return PairInfo(primary_idx=primary_idx, proper=proper, tlen=tlen)


@dataclass
class RescueCandidates:
    """Explicit (row, anchor) candidates for the device verifier."""

    rows: np.ndarray      # int32 seq row of the mate orientation to try
    anchors: np.ndarray   # int64 GLOBAL text begin anchors
    read_ids: np.ndarray  # int32 mate read id per candidate


def rescue_candidates(ranked: Ranked, n_reads: int, lengths: np.ndarray,
                      library_length: int, library_deviation: int,
                      band: int, max_anchor_matches: int = 4) -> RescueCandidates:
    """Anchors for unmapped mates of mapped reads (reference AnchorsVerifier
    scans the +-(ll+ld) window with Myers [U]; we tile the window with banded
    anchors spaced 2*band+1 apart so the band sweep covers every begin)."""
    m = ranked.matches
    h = n_reads // 2
    starts, ends = _groups(m, n_reads)
    empty = RescueCandidates(rows=np.zeros(0, np.int32),
                             anchors=np.zeros(0, np.int64),
                             read_ids=np.zeros(0, np.int32))
    if len(m) == 0:
        return empty

    mapped = ends > starts
    mate = np.concatenate([np.arange(h) + h, np.arange(h)])
    rids = np.flatnonzero(mapped & ~mapped[mate])     # mapped read, unmapped mate
    if len(rids) == 0:
        return empty

    # up to max_anchor_matches anchor matches per selected read
    n_a = np.minimum(ends[rids] - starts[rids], max_anchor_matches).astype(np.int64)
    sel = np.repeat(np.arange(len(rids), dtype=np.int64), n_a)
    off = np.zeros(len(rids), dtype=np.int64)
    np.cumsum(n_a[:-1], out=off[1:] if len(rids) > 1 else off[1:])
    ka = np.arange(int(n_a.sum()), dtype=np.int64) - off[sel]
    k = starts[rids][sel] + ka                        # anchor match rows
    rid_k = rids[sel]
    mate_k = mate[rid_k]
    mlen = lengths[mate_k].astype(np.int64)

    fwd = m.strand[k] == 0
    # anchor fwd -> mate rc, end2 in [b1+ll-ld, b1+ll+ld]
    # anchor rc  -> mate fwd, begin2 in [e1-ll-ld, e1-ll+ld]
    lo = np.where(fwd,
                  m.begin[k] + library_length - library_deviation - mlen,
                  m.end[k] - library_length - library_deviation)
    mate_strand = np.where(fwd, 1, 0).astype(np.int64)

    # tile each window with W banded anchors (constant W: window width is
    # 2*ld+1 for every candidate)
    stride = 2 * band + 1
    W = (2 * library_deviation) // stride + 1
    anchors = (np.repeat(lo, W)
               + np.tile(np.arange(W, dtype=np.int64) * stride, len(lo)))
    rows = np.repeat(mate_k + mate_strand * n_reads, W).astype(np.int32)
    read_ids = np.repeat(mate_k, W).astype(np.int32)
    return RescueCandidates(rows=rows, anchors=anchors, read_ids=read_ids)
