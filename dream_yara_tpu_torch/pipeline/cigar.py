"""CIGAR production for reported matches (host side).

Reference analog: src/mapper_aligner.h MatchesAligner [U] — banded global
re-alignment of read vs text[begin:end] at the known edit distance, M/I/D ops
only (Yara's all-mapper model has no soft clips, SURVEY.md §2.9).

Vectorized NumPy across matches: the DP fills (C, W) band rows per read
position; traceback walks all matches in lockstep. Fast path: when the edit
distance equals the Hamming distance on an equal-length span, the CIGAR is
pure <m>M with no DP.

Traceback preference (deterministic, part of the output contract): diagonal
(M) > read-gap (I) > text-gap (D) on ties, resolved right-to-left.
"""

from __future__ import annotations

import numpy as np

INF = 1 << 20


def _sub_cost(a, b):
    return ((a != b) | (a >= 4) | (b >= 4)).astype(np.int32)


def compute_cigars(text: np.ndarray, reads: np.ndarray, rows: np.ndarray,
                   lengths: np.ndarray, begins: np.ndarray, ends: np.ndarray,
                   max_err: int, dists: np.ndarray | None = None,
                   block: int = 4096) -> list[str]:
    """CIGAR strings for matches; read i = reads[rows[i], :lengths[i]] vs
    text[begins[i]:ends[i]]. All inputs host numpy. Processed in blocks to
    bound the (L+1, C, W) choice tensor.

    When `dists` (the already-verified edit distances) is given, matches whose
    span length equals the read length AND whose Hamming distance equals the
    known edit distance take the pure-<m>M fast path with NO DP — on
    substitution-dominated data that is nearly all of them."""
    C = len(rows)
    if C == 0:
        return []
    if dists is not None:
        try:
            from ..native import align as nat_align
            if nat_align.available():
                return nat_align.compute_cigars_native(
                    text, reads, rows, lengths, begins, ends, dists, max_err)
        except ImportError:
            pass
    if dists is None:
        out: list[str] = []
        for s in range(0, C, block):
            sl = slice(s, s + block)
            out.extend(_cigars_block(text, reads, rows[sl], lengths[sl],
                                     begins[sl], ends[sl], max_err))
        return out

    m_arr = lengths.astype(np.int64)
    n_arr = (ends - begins).astype(np.int64)
    L = int(m_arr.max())
    eq = m_arr == n_arr
    span_idx = begins[:, None] + np.arange(L)[None, :]
    in_rng = (np.arange(L)[None, :] < m_arr[:, None]) & (span_idx < ends[:, None])
    spans = np.where(in_rng, text[np.clip(span_idx, 0, len(text) - 1)], 6)
    reads_g = reads[rows][:, :L]
    pos_mask = np.arange(L)[None, :] < m_arr[:, None]
    ham = ((_sub_cost(reads_g, spans) & pos_mask) & in_rng).sum(axis=1) \
        + (pos_mask & ~in_rng).sum(axis=1)
    fast = eq & (ham == dists)

    cigars = np.empty(C, dtype=object)
    for m in np.unique(m_arr[fast]) if fast.any() else []:
        cigars[fast & (m_arr == m)] = f"{int(m)}M"
    slow = np.flatnonzero(~fast)
    slow_out: list[str] = []
    for s in range(0, len(slow), block):
        idx = slow[s : s + block]
        slow_out.extend(_cigars_block(text, reads, rows[idx], lengths[idx],
                                      begins[idx], ends[idx], max_err))
    for i, ci in zip(slow, slow_out):
        cigars[i] = ci
    return cigars.tolist()


def _cigars_block(text: np.ndarray, reads: np.ndarray, rows: np.ndarray,
                  lengths: np.ndarray, begins: np.ndarray, ends: np.ndarray,
                  max_err: int) -> list[str]:
    C = len(rows)
    if C == 0:
        return []
    m_arr = lengths.astype(np.int64)
    n_arr = (ends - begins).astype(np.int64)
    L = int(m_arr.max())
    E = max_err
    W = 2 * E + 1

    reads_g = reads[rows][:, :L]                              # (C, L)
    # gather spans padded to L+E with sentinel-like 6
    span_len = int(n_arr.max())
    span_idx = begins[:, None] + np.arange(span_len)[None, :]
    in_range = span_idx < ends[:, None]
    spans = np.where(in_range,
                     text[np.clip(span_idx, 0, len(text) - 1)], 6).astype(np.int8)

    cigars: list[str] = [""] * C

    # fast path: equal length + hamming distance achievable
    eq = m_arr == n_arr
    ham = np.full(C, INF, dtype=np.int64)
    if eq.any():
        pos = np.arange(L)[None, :]
        msk = pos < m_arr[:, None]
        hc = (_sub_cost(reads_g, spans[:, :L]) & msk).sum(axis=1)
        ham = np.where(eq, hc, INF)
    # full-DP distance for the slice (needed to decide the fast path and NM)
    need = np.arange(C)

    # --- banded global DP with stored choices ---
    # d = x - j + E in [0, 2E]; D[c, d]
    D = np.full((C, W), INF, dtype=np.int32)
    d_off = np.arange(W)
    x0 = d_off - E
    valid0 = (x0 >= 0) & (x0[None, :] <= n_arr[:, None])
    D = np.where(valid0, np.maximum(x0, 0)[None, :], INF).astype(np.int32)
    choices = np.zeros((L + 1, C, W), dtype=np.int8)  # 0=M/diag,2=I(up),3=D(left)

    for j in range(1, L + 1):
        rchar = reads_g[:, j - 1][:, None]                   # (C,1)
        x = j + x0[None, :] - 1                              # text index consumed by diag
        xc = np.clip(x, 0, span_len - 1)
        wchar = np.take_along_axis(spans, xc, axis=1)
        bad = (x < 0) | (x >= n_arr[:, None])
        sub = _sub_cost(rchar, wchar) + np.where(bad, INF, 0)
        diag = D + sub
        up = np.concatenate([D[:, 1:], np.full((C, 1), INF, np.int32)], axis=1) + 1
        nD = np.where(diag <= up, diag, up)
        ch = np.where(diag <= up, 0, 2).astype(np.int8)
        # in-row left (D op) sequential scan over band
        for d in range(1, W):
            cand = nD[:, d - 1] + 1
            better = cand < nD[:, d]
            nD[:, d] = np.where(better, cand, nD[:, d])
            ch[:, d] = np.where(better, 3, ch[:, d])
        # rows beyond this read's length: freeze
        alive = (j <= m_arr)[:, None]
        D = np.where(alive, nD, D)
        choices[j] = np.where(alive, ch, 0)

    final_d = (n_arr - m_arr + E).astype(np.int64)
    dist = D[need, np.clip(final_d, 0, W - 1)]

    # --- lockstep traceback ---
    K = L + E + 1
    moves = np.zeros((C, K), dtype=np.int8)  # filled from the right: 1=M,2=I,3=D
    jj = m_arr.copy()
    dd = final_d.copy()
    kk = np.full(C, K, dtype=np.int64)
    use_fast = (ham == dist) & eq
    active = (~use_fast) & (dist < INF)
    for _ in range(2 * L + 2 * E + 2):
        if not active.any():
            break
        c = choices[np.clip(jj, 0, L), need, np.clip(dd, 0, W - 1)]
        atrow0 = jj == 0
        # at j==0: remaining band offset = leading D ops
        c = np.where(atrow0, 3, c)
        done = atrow0 & (dd == E)
        step_active = active & ~done
        kk = np.where(step_active, kk - 1, kk)
        mv = np.where(c == 0, 1, np.where(c == 2, 2, 3))
        moves[np.arange(C)[step_active], kk[step_active]] = mv[step_active]
        jj = np.where(step_active & ((c == 0) | (c == 2)), jj - 1, jj)
        dd = np.where(step_active & (c == 2), dd + 1,
                      np.where(step_active & (c == 3), dd - 1, dd))
        active = active & ~done

    for i in range(C):
        if use_fast[i]:
            cigars[i] = f"{int(m_arr[i])}M"
            continue
        mv = moves[i, kk[i]:]
        if len(mv) == 0:
            cigars[i] = f"{int(m_arr[i])}M"
            continue
        # run-length encode
        parts = []
        sym = {1: "M", 2: "I", 3: "D"}
        runs = np.flatnonzero(np.diff(mv) != 0)
        prev = 0
        for r in list(runs + 1) + [len(mv)]:
            parts.append(f"{r - prev}{sym[int(mv[prev])]}")
            prev = r
        cigars[i] = "".join(parts)
    return cigars
