"""Host-side match table: dedup, ranking, strata, primary selection.

Reference analogs: src/bits_matches.h (Match records, duplicate removal,
stratum counting) + src/mapper_ranker.h rankMatches [U]. Vectorized NumPy on
flat arrays; the canonical total order (read_id, dist, begin, strand, end)
makes output deterministic regardless of device chunking or mesh shape
(SURVEY.md §2.9 tie-break requirement).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Matches:
    """Flat match table for one batch (one or many bins, global coords)."""

    read_id: np.ndarray  # int32
    strand: np.ndarray   # int8: 0 fwd, 1 rc
    begin: np.ndarray    # int64 global position (across bins)
    end: np.ndarray      # int64 exclusive
    dist: np.ndarray     # int32

    def __len__(self):
        return len(self.read_id)

    def take(self, idx) -> "Matches":
        return Matches(self.read_id[idx], self.strand[idx], self.begin[idx],
                       self.end[idx], self.dist[idx])

    @classmethod
    def concat(cls, parts: list["Matches"]) -> "Matches":
        if not parts:
            z = np.zeros(0, dtype=np.int64)
            return cls(z.astype(np.int32), z.astype(np.int8), z, z, z.astype(np.int32))
        return cls(*(np.concatenate([getattr(p, f) for p in parts])
                     for f in ("read_id", "strand", "begin", "end", "dist")))


def build_matches(row, begin, end, dist, ok, n_reads: int,
                  offset: int = 0) -> Matches:
    """From device MapStepOut arrays; `offset` shifts bin-local to global coords."""
    row = np.asarray(row)[np.asarray(ok)]
    return Matches(
        read_id=(row % n_reads).astype(np.int32),
        strand=(row // n_reads).astype(np.int8),
        begin=np.asarray(begin)[np.asarray(ok)].astype(np.int64) + offset,
        end=np.asarray(end)[np.asarray(ok)].astype(np.int64) + offset,
        dist=np.asarray(dist)[np.asarray(ok)].astype(np.int32),
    )


def _packable(m: Matches) -> bool:
    """True when the sort keys fit the packed two-word layout below."""
    if len(m) == 0:
        return False
    return (int(m.read_id.max()) < (1 << 20) and int(m.read_id.min()) >= 0
            and int(m.dist.max()) < 32 and int(m.begin.min()) >= 0
            and int(m.end.max()) < (1 << 43))


def _order_coord(m: Matches, coord: np.ndarray, tie: np.ndarray) -> np.ndarray:
    """Order by (read_id, strand, coord, dist, tie) via two packed uint64
    words (2 stable passes instead of 5 — the lexsort passes dominate the
    host rank/dedup stage at bench scale)."""
    hi = ((m.read_id.astype(np.uint64) << np.uint64(44))
          | (m.strand.astype(np.uint64) << np.uint64(43))
          | coord.astype(np.uint64))
    lo = (m.dist.astype(np.uint64) << np.uint64(43)) | tie.astype(np.uint64)
    return np.lexsort((lo, hi))


def dedup_matches(m: Matches) -> Matches:
    """Remove duplicates: same (read, strand, begin) or same (read, strand, end)
    keeps the lowest-distance variant (reference removeDuplicates semantics:
    sorted passes over begin- and end-coordinates [U])."""
    if len(m) == 0:
        return m
    fast = _packable(m)
    # pass 1: unique (read, strand, begin) keeping min (dist, end)
    order = (_order_coord(m, m.begin, m.end) if fast else
             np.lexsort((m.end, m.dist, m.begin, m.strand, m.read_id)))
    m = m.take(order)
    first = np.ones(len(m), dtype=bool)
    first[1:] = ((m.read_id[1:] != m.read_id[:-1]) | (m.strand[1:] != m.strand[:-1])
                 | (m.begin[1:] != m.begin[:-1]))
    m = m.take(first)
    # pass 2: unique (read, strand, end) keeping min (dist, begin)
    order = (_order_coord(m, m.end, m.begin) if fast else
             np.lexsort((m.begin, m.dist, m.end, m.strand, m.read_id)))
    m = m.take(order)
    first = np.ones(len(m), dtype=bool)
    first[1:] = ((m.read_id[1:] != m.read_id[:-1]) | (m.strand[1:] != m.strand[:-1])
                 | (m.end[1:] != m.end[:-1]))
    return m.take(first)


@dataclass
class Ranked:
    """Deduped matches in canonical order + per-read stratum stats."""

    matches: Matches          # sorted by (read_id, dist, begin, strand, end)
    primary: np.ndarray       # bool per match — first of its read group
    best: np.ndarray          # (n_reads,) int32 best distance (INT32_MAX if unmapped)
    c1: np.ndarray            # (n_reads,) int32 co-optimal count
    c2: np.ndarray            # (n_reads,) int32 sub-optimal count (dist > best)

    @property
    def mapped(self) -> np.ndarray:
        return self.c1 > 0


def rank_matches(m: Matches, n_reads: int, strata_count: int = 0) -> Ranked:
    """Canonical ordering + stratum stats + strata filtering.

    strata_count s: keep matches with dist <= best + s (reference -s flag:
    all-mapping within the best stratum plus s more [U])."""
    if _packable(m):
        # packed 3-pass edition of lexsort((end, strand, begin, dist, read_id))
        w1 = (m.read_id.astype(np.uint64) << np.uint64(5)) | m.dist.astype(np.uint64)
        w2 = (m.begin.astype(np.uint64) << np.uint64(1)) | m.strand.astype(np.uint64)
        order = np.lexsort((m.end, w2, w1))
    else:
        order = np.lexsort((m.end, m.strand, m.begin, m.dist, m.read_id))
    m = m.take(order)

    NOBEST = np.iinfo(np.int32).max
    best = np.full(n_reads, NOBEST, dtype=np.int64)
    if len(m):
        # sorted by (read_id, dist, ...): each group's first row has its best
        grp_first = np.ones(len(m), dtype=bool)
        grp_first[1:] = m.read_id[1:] != m.read_id[:-1]
        best[m.read_id[grp_first]] = m.dist[grp_first]

    keep = m.dist <= best[m.read_id] + strata_count
    m = m.take(keep)

    is_best = m.dist == best[m.read_id]
    c1 = np.bincount(m.read_id[is_best], minlength=n_reads).astype(np.int32)
    c2 = np.bincount(m.read_id[~is_best], minlength=n_reads).astype(np.int32)

    primary = np.ones(len(m), dtype=bool)
    primary[1:] = m.read_id[1:] != m.read_id[:-1]
    return Ranked(matches=m, primary=primary, best=best.astype(np.int32),
                  c1=c1, c2=c2)
