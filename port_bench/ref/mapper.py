"""The plain reference mapper: every match of a read within its error
budget over the whole database, ranked, paired and rescued as the output
contract (docs/OUTPUT_CONTRACT.md) states. NumPy only; it is handed the
generated sequences and reads and builds its own text and seed index.

Seeding is the contract's full sensitivity: E + 1 disjoint exact seeds of
length l // (E + 1) per strand, so every match within the budget has a
seed without an error. The prefilter is not modelled: the k-mer lemma
routes a read to every bin that holds a match within its budget, so
routing can only show in the SAM as a missing match.

A mapper that keeps at most `cap` hits of an exact seed in a bin (the
sensitivities `high` and `low`) finds a subset of a read's matches where
one of its seeds occurs more often. Such a read is marked `capped`: the
comparison then holds its best distance and not its set (core/check.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import align, seeds

PAD = 64                  # separators between bins: wider than any band
COMP = np.array([3, 2, 1, 0, 4, 5], np.int8)
LANES = 1 << 16           # lanes per verification call


def revcomp_rows(reads: np.ndarray) -> np.ndarray:
    return COMP[reads][:, ::-1]


def mapq(c1: int, c2: int) -> int:
    """The contract's MAPQ ladder."""
    if c1 == 1:
        return 40 if c2 == 0 else 20
    return {2: 3, 3: 1, 4: 1}.get(c1, 0)


@dataclass
class Text:
    """The reference's own global text: every contig between runs of PAD
    separators, and where each contig starts in it."""
    text: np.ndarray
    names: list[str]
    starts: np.ndarray
    lengths: np.ndarray
    ids: dict = field(default_factory=dict)

    @classmethod
    def build(cls, names: list[str], seqs: list[np.ndarray]) -> "Text":
        lengths = np.array([len(s) for s in seqs], np.int64)
        starts = PAD + np.concatenate([[0], np.cumsum(lengths + PAD)[:-1]])
        text = np.full(int(starts[-1] + lengths[-1] + PAD), align.SEP, np.int8)
        for s0, s in zip(starts, seqs):
            text[s0 : s0 + len(s)] = s
        return cls(text, list(names), starts, lengths,
                   {nm: i for i, nm in enumerate(names)})

    def contig_of(self, gpos: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.starts, gpos, side="right") - 1

    def clean_span(self, begin: np.ndarray, end: np.ndarray) -> np.ndarray:
        """Spans that lie inside one contig."""
        c = self.contig_of(begin)
        return (begin >= self.starts[c]) & (end <= self.starts[c] + self.lengths[c])


@dataclass
class Answer:
    """What a read's SAM record says, reduced to what the contract fixes:
    its kept matches (strand, begin, end, dist) in global coordinates of
    the reference's text, primary first; MAPQ; for a mate, the proper flag
    and TLEN."""
    matches: list
    mapq: int = 0
    proper: bool = False
    tlen: int = 0
    capped: bool = False

    @property
    def mapped(self) -> bool:
        return bool(self.matches)

    @property
    def best(self) -> int:
        return min(m[3] for m in self.matches) if self.matches else -1


def _rank(read, strand, begin, end, dist, n_reads, strata):
    """Contract dedup, then the best stratum (+ strata) in canonical order
    (dist, begin, strand fwd < rc, end): a list of match lists per read."""
    out = [[] for _ in range(n_reads)]
    if len(read) == 0:
        return out
    # same (read, strand, begin): keep min (dist, end)
    o = np.lexsort((end, dist, begin, strand, read))
    key = np.stack([read[o], strand[o], begin[o]], 1)
    first = np.ones(len(o), bool)
    first[1:] = (key[1:] != key[:-1]).any(1)
    o = o[first]
    # same (read, strand, end): keep min (dist, begin)
    read, strand, begin, end, dist = (a[o] for a in (read, strand, begin, end, dist))
    o = np.lexsort((begin, dist, end, strand, read))
    key = np.stack([read[o], strand[o], end[o]], 1)
    first = np.ones(len(o), bool)
    first[1:] = (key[1:] != key[:-1]).any(1)
    o = o[first]
    read, strand, begin, end, dist = (a[o] for a in (read, strand, begin, end, dist))
    o = np.lexsort((end, strand, begin, dist, read))
    for r, s, b, e, d in zip(read[o], strand[o], begin[o], end[o], dist[o]):
        out[int(r)].append((int(s), int(b), int(e), int(d)))
    for r, ms in enumerate(out):
        if ms:
            best = ms[0][3]
            out[r] = [m for m in ms if m[3] <= best + strata]
    return out


def _verify(text: Text, oriented: np.ndarray, lane_read, lane_strand,
            lane_anchor, E: int, budget: np.ndarray):
    """Verify (read, strand, anchor) lanes; keep matches within budget
    inside one contig."""
    parts = []
    for c0 in range(0, len(lane_read), LANES):
        r = lane_read[c0 : c0 + LANES]
        s = lane_strand[c0 : c0 + LANES]
        a = lane_anchor[c0 : c0 + LANES]
        dist, beg, end = align.banded_verify(text.text, a, oriented[s, r], E)
        ok = (dist <= budget[r]) & text.clean_span(beg, end)
        parts.append((r[ok], s[ok], beg[ok], end[ok], dist[ok]))
    if not parts:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z
    return tuple(np.concatenate(x) for x in zip(*parts))


def _capped(text: Text, q: np.ndarray, pos: np.ndarray, clean: np.ndarray,
            n: int, ns: int, cap: int) -> np.ndarray:
    """(n,) bool: reads one of whose seeds (index q into the (strand, read,
    seed) order) occurs more than `cap` times in one contig, or holds a
    base other than A/C/G/T. A seed longer than 32 is counted by its first
    32 bases, which can only mark more reads."""
    n_contigs = len(text.starts)
    key, cnt = np.unique(q * n_contigs + text.contig_of(pos), return_counts=True)
    over = np.concatenate([key[cnt > cap] // n_contigs, np.flatnonzero(~clean)])
    out = np.zeros(n, bool)
    out[(over % (n * ns)) // ns] = True
    return out


def map_reads(text: Text, reads: np.ndarray, error_rate: float,
              strata: int = 0, cap: int | None = None):
    """Kept matches of every read (rows of `reads`, one length m) over the
    whole text: a list of match lists, canonical order; and the (n,) bool
    `capped` of a mapper that keeps `cap` hits a seed (None: none)."""
    n, m = reads.shape
    rate_ppm = int(round(error_rate * 10_000))
    budget = np.full(n, (m * rate_ppm) // 10_000, np.int64)
    E = max(1, int(np.floor(m * error_rate)))
    ns = int(budget[0]) + 1
    slen = m // ns
    oriented = np.stack([reads, revcomp_rows(reads)])      # (2, n, m)
    seed_rows = oriented[:, :, : ns * slen].reshape(2, n, ns, slen)
    # a seed's first 32 bases (one packed word) find a superset of its
    # occurrences; verification keeps what lies within the budget
    flat = seed_rows[..., : min(slen, 32)].reshape(2 * n * ns, -1)
    clean = (flat < 4).all(1)
    qi, pos = seeds.occurrences(text.text, flat[clean])
    q = np.flatnonzero(clean)[qi]
    strand, rest = np.divmod(q, n * ns)
    read, s = np.divmod(rest, ns)
    anchor = pos - s * slen
    lanes = np.unique(np.stack([read, strand, anchor], 1), axis=0)
    r, st, b, e, d = _verify(text, oriented, lanes[:, 0], lanes[:, 1],
                             lanes[:, 2], E, budget)
    capped = (np.zeros(n, bool) if cap is None
              else _capped(text, q, pos, clean, n, ns, cap))
    return _rank(r, st, b, e, d, n, strata), capped


def se_answers(text: Text, reads: np.ndarray, error_rate: float,
               strata: int = 0, cap: int | None = None) -> list[Answer]:
    out = []
    found, capped = map_reads(text, reads, error_rate, strata, cap)
    for ms, c in zip(found, capped):
        best = [x for x in ms if x[3] == ms[0][3]] if ms else []
        out.append(Answer(ms, mapq(len(best), len(ms) - len(best)),
                          capped=bool(c)))
    return out


def pe_answers(text: Text, mates1: np.ndarray, mates2: np.ndarray,
               error_rate: float, library_length: int, library_deviation: int,
               rescue: bool = True, strata: int = 0, cap: int | None = None):
    """Answers of mates 1 then mates 2: mapping, mate rescue in the
    tiled insert window, pair choice (d1 + d2, begin1, begin2, strand1)
    among proper FR combinations, TLEN. Both mates of a pair with a
    capped mate are capped: the pair choice reads both sets."""
    h, m = mates1.shape
    reads = np.concatenate([mates1, mates2])
    n = 2 * h
    ms, capped = map_reads(text, reads, error_rate, strata, cap)
    capped = np.tile(capped[:h] | capped[h:], 2)
    rate_ppm = int(round(error_rate * 10_000))
    budget = np.full(n, (m * rate_ppm) // 10_000, np.int64)
    E = max(1, int(np.floor(m * error_rate)))
    ll, ld = library_length, library_deviation
    if rescue:
        oriented = np.stack([reads, revcomp_rows(reads)])
        stride = 2 * E + 1
        lr, ls, la = [], [], []
        for rid in range(n):
            mate = rid + h if rid < h else rid - h
            if ms[rid] or not ms[mate]:
                continue
            for (s0, b0, e0, _d) in ms[mate][:4]:
                if s0 == 0:
                    lo, st = b0 + ll - ld - m, 1
                else:
                    lo, st = e0 - ll - ld, 0
                a = np.arange(lo, lo + 2 * ld + 1, stride, dtype=np.int64)
                la.append(a)
                lr.append(np.full(len(a), rid, np.int64))
                ls.append(np.full(len(a), st, np.int64))
        if la:
            r, st, b, e, d = _verify(text, oriented, np.concatenate(lr),
                                     np.concatenate(ls), np.concatenate(la),
                                     E, budget)
            resc = _rank(r, st, b, e, d, n, strata)
            for rid in np.unique(r):
                ms[int(rid)] = resc[int(rid)]
    answers = []
    for rid in range(n):
        best = [x for x in ms[rid] if x[3] == ms[rid][0][3]] if ms[rid] else []
        answers.append(Answer(list(ms[rid]), mapq(len(best), len(ms[rid]) - len(best)),
                              capped=bool(capped[rid])))
    for r1 in range(h):
        a1, a2 = answers[r1], answers[r1 + h]
        choice = None
        for x in a1.matches:
            for y in a2.matches:
                if x[0] == y[0] or text.contig_of(x[1]) != text.contig_of(y[1]):
                    continue
                t = (y[2] - x[1]) if x[0] == 0 else (x[2] - y[1])
                if not ll - ld <= t <= ll + ld:
                    continue
                key = (x[3] + y[3], x[1], y[1], x[0])
                if choice is None or key < choice[0]:
                    choice = (key, x, y)
        if choice is not None:
            _, x, y = choice
            a1.matches.remove(x)
            a1.matches.insert(0, x)
            a2.matches.remove(y)
            a2.matches.insert(0, y)
            a1.proper = a2.proper = True
        if a1.mapped and a2.mapped:
            x, y = a1.matches[0], a2.matches[0]
            if text.contig_of(x[1]) == text.contig_of(y[1]):
                t = max(x[2], y[2]) - min(x[1], y[1])
                left = x[1] <= y[1]            # mate 1 wins ties
                a1.tlen, a2.tlen = (t, -t) if left else (-t, t)
    return answers
