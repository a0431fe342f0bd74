"""Golden model: scalar-Python single-bin mapper — the behavioral oracle.

SURVEY.md §7 step 1: a host-side golden model of the whole pipeline
establishes the output contract and oracles every device kernel. This is a
deliberate scalar transcription of the specified algorithms (pigeonhole
seeding, exact backward search, banded semi-global verification with the
documented tie-breaks, dedup/rank/MAPQ) with NO shared code with the device
path beyond the host FMIndex — vectorization/masking/indexing bugs in ops/ and
pipeline/ cannot cancel out here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

INF = 1 << 20


def golden_verify(text, anchor, read, E):
    """Scalar banded semi-global DP, identical spec to ops/verify.banded_verify:
    prefer diagonal over read-gap on ties; in-row scan takes a left origin only
    when strictly better; final d = smallest with min dist."""
    m = len(read)
    W = 2 * E + 1
    n = len(text)

    def wchar(x):
        p = anchor - E + x
        return int(text[p]) if 0 <= p < n else 6

    D = [0] * W
    S = list(range(W))
    for j in range(m):
        diag = [D[d] + (1 if (read[j] != wchar(j + d) or read[j] >= 4
                              or wchar(j + d) >= 4) else 0) for d in range(W)]
        up = [(D[d + 1] + 1) if d + 1 < W else INF for d in range(W)]
        upS = [S[d + 1] if d + 1 < W else 0 for d in range(W)]
        nD, nS = [], []
        for d in range(W):
            if up[d] < diag[d]:
                nD.append(up[d]); nS.append(upS[d])
            else:
                nD.append(diag[d]); nS.append(S[d])
        for d in range(1, W):
            if nD[d - 1] + 1 < nD[d]:
                nD[d] = nD[d - 1] + 1
                nS[d] = nS[d - 1]
        D, S = nD, nS
    best = min(D)
    d_best = D.index(best)
    begin = anchor - E + S[d_best]
    end = anchor - E + m + d_best
    return best, begin, end


@dataclass
class GoldenRead:
    matches: list  # [(dist, begin, end, strand)] canonical order
    best: int
    c1: int
    c2: int
    mapq: int


def golden_map_se(store, fm, batch, error_rate=0.05, strata_count=0,
                  max_errors=None):
    """Map every read of the batch; returns list[GoldenRead]."""
    text = store.text
    n = batch.n_reads
    rate_ppm = int(round(error_rate * 10_000))
    out = []
    L = batch.max_len
    E_band = max_errors if max_errors is not None else max(1, int(np.floor(L * error_rate)))

    # contig span check
    sent = np.flatnonzero(text == 5)

    def crosses_sentinel(b, e):
        i = np.searchsorted(sent, b)
        return i < len(sent) and sent[i] < e

    for rid in range(n):
        l = int(batch.lengths[rid])
        e_budget = (l * rate_ppm) // 10_000
        ns = e_budget + 1
        slen = l // ns
        found = {}
        for strand in (0, 1):
            seq = batch.seqs[batch.seq_row(rid, bool(strand)), :l]
            anchors = set()
            for s in range(ns):
                seed = seq[s * slen : (s + 1) * slen]
                lo, hi = fm.backward_search(seed)
                for r in range(lo, hi):
                    anchors.add(fm.locate(r) - s * slen)
            for a in sorted(anchors):
                dist, beg, end = golden_verify(text, a, seq, E_band)
                if dist <= e_budget and beg >= 0 and end <= len(text) \
                        and not crosses_sentinel(beg, end):
                    key = (strand, beg, end)
                    if key not in found or dist < found[key]:
                        found[key] = dist
        # dedup by (strand, begin) then (strand, end), keep min (dist, other)
        by_begin = {}
        for (strand, beg, end), dist in found.items():
            k = (strand, beg)
            cur = by_begin.get(k)
            if cur is None or (dist, end) < (cur[1], cur[0]):
                by_begin[k] = (end, dist)
        stage2 = {}
        for (strand, beg), (end, dist) in by_begin.items():
            k = (strand, end)
            cur = stage2.get(k)
            if cur is None or (dist, beg) < (cur[1], cur[0]):
                stage2[k] = (beg, dist)
        matches = sorted(
            (dist, beg, strand, end)
            for (strand, end), (beg, dist) in stage2.items())
        if not matches:
            out.append(GoldenRead([], INF, 0, 0, 0))
            continue
        best = matches[0][0]
        matches = [mt for mt in matches if mt[0] <= best + strata_count]
        c1 = sum(1 for mt in matches if mt[0] == best)
        c2 = len(matches) - c1
        if c1 == 1:
            mapq = 40 if c2 == 0 else 20
        elif c1 == 2:
            mapq = 3
        elif c1 in (3, 4):
            mapq = 1
        else:
            mapq = 0
        out.append(GoldenRead(
            [(d, b, e, s) for (d, b, s, e) in matches], best, c1, c2, mapq))
    return out


def golden_map_pe(store, fm, batch, error_rate=0.05, strata_count=0,
                  library_length=200, library_deviation=100, rescue=True,
                  max_errors=None):
    """Scalar PE oracle: SE mapping per mate + mate rescue + pair selection,
    mirroring docs/OUTPUT_CONTRACT.md exactly (same tiled rescue anchors,
    same combo key). Returns (reads: list[GoldenRead],
    primaries: list[(strand,begin,end,dist)|None], proper: list[bool],
    tlen: list[int])."""
    n = batch.n_reads
    h = n // 2
    L = batch.max_len
    rate_ppm = int(round(error_rate * 10_000))
    E_band = max_errors if max_errors is not None else max(1, int(np.floor(L * error_rate)))
    text = store.text
    sent = np.flatnonzero(text == 5)

    def crosses(b, e):
        i = np.searchsorted(sent, b)
        return i < len(sent) and sent[i] < e

    reads = golden_map_se(store, fm, batch, error_rate=error_rate,
                          strata_count=strata_count, max_errors=max_errors)

    if rescue:
        stride = 2 * E_band + 1
        for rid in range(n):
            mate = rid + h if rid < h else rid - h
            if reads[rid].matches or not reads[mate].matches:
                continue
            mlen = int(batch.lengths[rid])
            budget = (mlen * rate_ppm) // 10_000
            found = {}
            for (d0, beg0, end0, s0) in reads[mate].matches[:4]:
                if s0 == 0:
                    lo = beg0 + library_length - library_deviation - mlen
                    hi = beg0 + library_length + library_deviation - mlen
                    strand = 1
                else:
                    lo = end0 - library_length - library_deviation
                    hi = end0 - library_length + library_deviation
                    strand = 0
                seq = batch.seqs[batch.seq_row(rid, bool(strand)), :mlen]
                for a in range(lo, hi + 1, stride):
                    dist, beg, end = golden_verify(text, a, seq, E_band)
                    if dist <= budget and beg >= 0 and end <= len(text) \
                            and not crosses(beg, end):
                        key = (strand, beg, end)
                        if key not in found or dist < found[key]:
                            found[key] = dist
            if not found:
                continue
            # same dedup/rank spec as golden_map_se
            by_begin = {}
            for (s, b, e), d in found.items():
                cur = by_begin.get((s, b))
                if cur is None or (d, e) < (cur[1], cur[0]):
                    by_begin[(s, b)] = (e, d)
            stage2 = {}
            for (s, b), (e, d) in by_begin.items():
                cur = stage2.get((s, e))
                if cur is None or (d, b) < (cur[1], cur[0]):
                    stage2[(s, e)] = (b, d)
            mt = sorted((d, b, s, e) for (s, e), (b, d) in stage2.items())
            best = mt[0][0]
            mt = [x for x in mt if x[0] <= best + strata_count]
            c1 = sum(1 for x in mt if x[0] == best)
            c2 = len(mt) - c1
            mapq = (40 if c2 == 0 else 20) if c1 == 1 else \
                (3 if c1 == 2 else (1 if c1 in (3, 4) else 0))
            reads[rid] = GoldenRead(
                [(d, b, e, s) for (d, b, s, e) in mt], best, c1, c2, mapq)

    # pair selection (contract: minimize (d1+d2, begin1, begin2, strand1))
    primaries = [None] * n
    proper = [False] * n
    tlen = [0] * n
    lo_t = library_length - library_deviation
    hi_t = library_length + library_deviation
    for r1 in range(h):
        r2 = r1 + h
        m1, m2 = reads[r1].matches, reads[r2].matches
        if m1:
            primaries[r1] = m1[0]
        if m2:
            primaries[r2] = m2[0]
        if not m1 or not m2:
            continue
        contig_of = lambda b: int(np.searchsorted(store.offsets, b, side="right")) - 1
        best = None
        for (d1, b1, e1, s1) in m1:
            for (d2, b2, e2, s2) in m2:
                if s1 == s2 or contig_of(b1) != contig_of(b2):
                    continue
                t = (e2 - b1) if s1 == 0 else (e1 - b2)
                if not (lo_t <= t <= hi_t):
                    continue
                key = (d1 + d2, b1, b2, s1)
                if best is None or key < best[0]:
                    best = (key, (d1, b1, e1, s1), (d2, b2, e2, s2), t)
        if best is not None:
            _, p1, p2, t = best
            primaries[r1], primaries[r2] = p1, p2
            proper[r1] = proper[r2] = True
            tlen[r1] = t if p1[1] <= p2[1] else -t
            tlen[r2] = -tlen[r1]
    return reads, primaries, proper, tlen
