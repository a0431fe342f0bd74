"""Banded semi-global verification and CIGAR costs, in plain NumPy.

The semantics are the mapper's published output contract
(docs/OUTPUT_CONTRACT.md, "Alignment semantics" and "Tie-breaks"): N and
the contig separator mismatch everything, N against N included; among the
optimal alignments in the band the smallest end diagonal wins; the begin
is carried through the DP preferring the diagonal over a read gap on
ties, and an in-row text gap is taken only when strictly better. This file
is written from that text, vectorised over lanes; it shares no code with
the mapper.
"""

from __future__ import annotations

import re

import numpy as np

INF = 1 << 20
SEP = 5            # separator code of the reference's own global text
CIGAR_OP = re.compile(rb"(\d+)([MID])")


def windows(text: np.ndarray, anchors: np.ndarray, width: int) -> np.ndarray:
    """(C, width) text characters starting at each anchor, SEP outside."""
    idx = anchors[:, None] + np.arange(width, dtype=np.int64)[None, :]
    inside = (idx >= 0) & (idx < len(text))
    out = np.where(inside, text[np.clip(idx, 0, len(text) - 1)], SEP)
    return out.astype(np.int8)


def banded_verify(text: np.ndarray, anchors: np.ndarray, reads: np.ndarray,
                  E: int):
    """Verify every lane: read `reads[c]` (all of one length m) against the
    band of half-width E around text position `anchors[c]`.

    Returns (dist, begin, end), int64 arrays of C lanes."""
    C, m = reads.shape
    W = 2 * E + 1
    anchors = anchors.astype(np.int64)
    if C == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    win = windows(text, anchors - E, m + 2 * E)
    D = np.zeros((C, W), np.int64)
    S = np.broadcast_to(np.arange(W, dtype=np.int64), (C, W)).copy()
    inf_col = np.full((C, 1), INF, np.int64)
    zero_col = np.zeros((C, 1), np.int64)
    for j in range(m):
        t = win[:, j : j + W]
        r = reads[:, j : j + 1]
        cost = ((r != t) | (r >= 4) | (t >= 4)).astype(np.int64)
        diag = D + cost
        up = np.concatenate([D[:, 1:] + 1, inf_col], axis=1)
        up_s = np.concatenate([S[:, 1:], zero_col], axis=1)
        take_up = up < diag
        D = np.where(take_up, up, diag)
        S = np.where(take_up, up_s, S)
        for d in range(1, W):
            left = D[:, d - 1] + 1
            better = left < D[:, d]
            D[:, d] = np.where(better, left, D[:, d])
            S[:, d] = np.where(better, S[:, d - 1], S[:, d])
    d_best = np.argmin(D, axis=1)
    rows = np.arange(C)
    dist = D[rows, d_best]
    begin = anchors - E + S[rows, d_best]
    end = anchors - E + m + d_best
    return dist, begin, end


def cigar_ops(cigar: bytes) -> list[tuple[int, bytes]] | None:
    """[(length, op)] of an M/I/D CIGAR, or None when it is not one."""
    ops = [(int(n), op) for n, op in CIGAR_OP.findall(cigar)]
    if not ops or b"".join(b"%d%s" % o for o in ops) != cigar:
        return None
    return ops


def cigar_cost(read: np.ndarray, text: np.ndarray, begin: int, cigar: bytes):
    """(edits, text span, read span) of `read` aligned at text `begin` by
    `cigar`, N and separators mismatching everything; None for a CIGAR
    that is not M/I/D."""
    ops = cigar_ops(cigar)
    if ops is None:
        return None
    qi, ti, edits = 0, int(begin), 0
    for n, op in ops:
        if op == b"M":
            if ti < 0 or ti + n > len(text) or qi + n > len(read):
                return None
            q = read[qi : qi + n]
            t = text[ti : ti + n]
            edits += int(((q != t) | (q >= 4) | (t >= 4)).sum())
            qi += n
            ti += n
        elif op == b"I":
            edits += n
            qi += n
        else:
            edits += n
            ti += n
    return edits, ti - int(begin), qi
