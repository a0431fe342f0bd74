"""Search-scheme approximate seed search on the bidirectional FM index
(counterpart of dream_yara_tpu/ops/bidir_search.py).

A pattern is tracked as (l, h, lr, hr): its SA interval in the forward
index and the interval of its reverse in the reverse-text index. Extending
left is a backward step on the forward rows; extending right a backward
step on the reverse rows (index/bifm.py). The other interval is realigned
by the count of smaller symbols between the two bounds, which the same
fetched row gives (ops/rank.py rank_lt_fused_rows), so an extension costs
one row fetch per bound, like a plain rank query.

Each scheme walks its exact part once per seed over (S,) states, then forks
(S, NL) substitution lanes over the other parts (Hamming only):
  budget 1, parts A = [0, hm), B = [hm, m):
    S1  B exact (backward)  -> 1 sub in A
    S2  A exact (forward)   -> <= 1 sub in B
  budget 2, parts A = [0, am), B = [am, bm), C = [bm, m):
    S1  C exact -> <= 2 subs in A + B (backward)
    S2  A exact -> subs in B + C, >= 1 in C (forward)
    S3  B exact -> 1 sub in A, then 1 in C
Lanes lie on the m-grid, so only seeds whose window is exactly m chars are
searched; the caller picks this backend only when every window is full.
"""

from __future__ import annotations

import numpy as np
import torch

from .rank import rank_fused, rank_lt_fused_rows
from .row_gather_cuda import gather_rows

_LOG2_BLOCK = 7


def _ext_core(fused, counts, lo, hi, c):
    """New (lo, hi) for symbol c, and the count of symbols < c between the
    two bounds: one row fetch over the concatenated (lo, hi) queries."""
    shape = lo.shape
    cf = c.reshape(-1)
    Q = cf.shape[0]
    bounds = torch.cat([lo.reshape(-1), hi.reshape(-1)])
    row = gather_rows(fused, bounds >> _LOG2_BLOCK)             # (2Q, 24)
    rank_c, rank_lt = rank_lt_fused_rows(row, cf.repeat(2), bounds & 127)
    cbase = counts[cf.long()]
    nlo = cbase + rank_c[:Q]
    nhi = cbase + rank_c[Q:]
    less = rank_lt[Q:] - rank_lt[:Q]
    return nlo.reshape(shape), nhi.reshape(shape), less.reshape(shape)


def extend_left(fused, counts, l, h, lr, hr, c):
    """Batched bidirectional extendLeft (index/bifm.py semantics)."""
    nl, nh, less = _ext_core(fused, counts, l, h, c)
    nlr = lr + less
    return nl, nh, nlr, nlr + (nh - nl)


def extend_right(rfused, rcounts, l, h, lr, hr, c):
    """Batched bidirectional extendRight via the reverse-text rank rows."""
    nlr, nhr, less = _ext_core(rfused, rcounts, lr, hr, c)
    nl = l + less
    return nl, nl + (nhr - nlr), nlr, nhr


def _sub_tables_budget2(m: int):
    """Lane tables of the budget-2 schemes on the m-grid (numpy)."""
    am, bm = m // 3, (2 * m) // 3
    f = lambda *xs: tuple(np.asarray(x, np.int32) for x in xs)
    # S1: <= 2 subs in [0, bm); singles are (p, o, p, 0)
    p1, o1, p2, o2 = [0], [0], [0], [0]          # exact lane
    for p in range(bm):
        for o in (1, 2, 3):
            p1.append(p); o1.append(o); p2.append(p); o2.append(0)
    for a in range(bm):
        for b in range(a + 1, bm):
            for oa in (1, 2, 3):
                for ob in (1, 2, 3):
                    p1.append(a); o1.append(oa); p2.append(b); o2.append(ob)
    s1 = f(p1, o1, p2, o2)
    # S2: subs in [am, m), the second one in [bm, m) (>= 1 in C)
    p1, o1, p2, o2 = [], [], [], []
    for p in range(bm, m):
        for o in (1, 2, 3):
            p1.append(p); o1.append(o); p2.append(p); o2.append(0)
    for a in range(am, m):
        for b in range(max(a + 1, bm), m):
            for oa in (1, 2, 3):
                for ob in (1, 2, 3):
                    p1.append(a); o1.append(oa); p2.append(b); o2.append(ob)
    s2 = f(p1, o1, p2, o2)
    # S3: one sub in A (pa, oa) x one sub in C (pc, oc)
    s3a = f([p for p in range(am) for _ in (1, 2, 3)],
            [o for _ in range(am) for o in (1, 2, 3)])
    s3c = f([p for p in range(bm, m) for _ in (1, 2, 3)],
            [o for _ in range(bm, m) for o in (1, 2, 3)])
    return am, bm, s1, s2, s3a, s3c


def _sub_tables_budget1(m: int):
    hm = m // 2
    f = lambda *xs: tuple(np.asarray(x, np.int32) for x in xs)
    s1 = f([p for p in range(hm) for _ in (1, 2, 3)],
           [o for _ in range(hm) for o in (1, 2, 3)])
    s2 = f([0] + [p for p in range(hm, m) for _ in (1, 2, 3)],   # exact lane first
           [0] + [o for _ in range(hm, m) for o in (1, 2, 3)])
    return hm, s1, s2


def bidir_seed_search(fused, counts, rfused, rcounts, n, reads, rows, starts,
                      slens, max_slen: int, *, budget: int = 1):
    """Forward-index SA intervals of every <= budget-substitution layout of
    each seed's last max_slen chars, by shared-prefix search schemes.

    Same contract as approx_search.seed_search_edits (Hamming layouts):
    returns (lo, hi, valid, w_start) with (S, NL_total) int32 intervals.
    Seeds whose window is shorter than max_slen come out invalid."""
    S = rows.shape[0]
    L = reads.shape[1]
    m = int(max_slen)
    dev = rows.device
    flat = reads.reshape(-1)
    full = slens >= m                                    # (S,) uniform gate
    w_start = starts + slens - slens.clamp(max=m)
    row_base = rows.long() * L
    n_t = torch.as_tensor(n, dtype=torch.int32, device=dev)
    lane = lambda x: torch.from_numpy(x).to(dev)[None, :]

    def wchar(pos):
        """Window char at window position `pos`, (S,) or (S, NL)."""
        if pos.dim() == 2:
            ridx = (w_start[:, None] + pos).clamp(0, L - 1)
            return flat[row_base[:, None] + ridx.long()].to(torch.int32)
        ridx = (w_start + pos).clamp(0, L - 1)
        return flat[row_base + ridx.long()].to(torch.int32)

    def subbed(c, pos, p, off):
        """Apply substitution offset `off` where pos == p (ACGT only)."""
        return torch.where((pos == p) & (c < 4), (c + off) % 4, c)

    def init():
        lo = torch.zeros(S, dtype=torch.int32, device=dev)
        return lo, torch.where(full, n_t, 0).to(torch.int32)

    def fork(state, nl):
        return tuple(x[:, None].expand(S, nl) for x in state)

    def lane_pos(first, sign, nl):
        """(S, nl) window position at step t: first + sign * t for full
        seeds, -1 (no step) for the others."""
        return lambda t: torch.where(full[:, None], first + sign * t,
                                     -1).expand(S, nl)

    def seed_pos(first, sign):
        return lambda t: torch.where(full, first + sign * t, -1)

    def back_walk(lo, hi, steps, posfn, charfn):
        """Backward (extend-left, forward interval only) lockstep walk."""
        for t in range(steps):
            pos = posfn(t)
            c = charfn(pos)
            cf = c.reshape(-1)
            ranks = rank_fused(fused, cf.repeat(2),
                               torch.cat([lo.reshape(-1), hi.reshape(-1)]))
            Q = cf.shape[0]
            cc = counts[cf.long()]
            nlo = (cc + ranks[:Q]).reshape(lo.shape)
            nhi = (cc + ranks[Q:]).reshape(lo.shape)
            upd = (pos >= 0) & (lo < hi)
            lo, hi = torch.where(upd, nlo, lo), torch.where(upd, nhi, hi)
        return lo, hi

    def bi_walk(state, steps, posfn, charfn, direction):
        """Bidirectional lockstep walk keeping (l, h, lr, hr) in sync."""
        ext, tabs = ((extend_left, (fused, counts)) if direction == "left"
                     else (extend_right, (rfused, rcounts)))
        for t in range(steps):
            l, h, lr, hr = state
            pos = posfn(t)
            c = charfn(pos)
            nxt = ext(*tabs, l, h, lr, hr, c)
            upd = (pos >= 0) & (l < h)
            state = tuple(torch.where(upd, a, b) for a, b in zip(nxt, state))
        return state

    outs = []
    if budget == 1:
        hm, (p1, o1), (p2, o2) = _sub_tables_budget1(m)
        # S1: shared backward walk of B = [hm, m), then 1 sub in A
        slo, shi = back_walk(*init(), m - hm, seed_pos(m - 1, -1), wchar)
        P1, O1 = lane(p1), lane(o1)
        llo, lhi = back_walk(*fork((slo, shi), P1.shape[1]), hm,
                             lane_pos(hm - 1, -1, P1.shape[1]),
                             lambda pos: subbed(wchar(pos), pos, P1, O1))
        outs.append((llo, lhi))
        # S2: shared forward walk of A = [0, hm), then <= 1 sub in B
        l0, h0 = init()
        st = bi_walk((l0, h0, l0, h0), hm, seed_pos(0, 1), wchar, "right")
        P2, O2 = lane(p2), lane(o2)
        lst = bi_walk(fork(st, P2.shape[1]), m - hm,
                      lane_pos(hm, 1, P2.shape[1]),
                      lambda pos: subbed(wchar(pos), pos, P2, O2), "right")
        outs.append(lst[:2])
    elif budget == 2:
        am, bm, s1, s2, (pa, oa), (pc, oc) = _sub_tables_budget2(m)
        # S1: shared backward C = [bm, m), then <= 2 subs in [0, bm)
        slo, shi = back_walk(*init(), m - bm, seed_pos(m - 1, -1), wchar)
        P1a, O1a, P1b, O1b = (lane(x) for x in s1)
        nl1 = P1a.shape[1]
        llo, lhi = back_walk(
            *fork((slo, shi), nl1), bm, lane_pos(bm - 1, -1, nl1),
            lambda pos: subbed(subbed(wchar(pos), pos, P1a, O1a),
                               pos, P1b, O1b))
        outs.append((llo, lhi))
        # S2: shared forward A = [0, am), subs in [am, m), >= 1 in C
        l0, h0 = init()
        st = bi_walk((l0, h0, l0, h0), am, seed_pos(0, 1), wchar, "right")
        P2a, O2a, P2b, O2b = (lane(x) for x in s2)
        nl2 = P2a.shape[1]
        lst = bi_walk(fork(st, nl2), m - am, lane_pos(am, 1, nl2),
                      lambda pos: subbed(subbed(wchar(pos), pos, P2a, O2a),
                                         pos, P2b, O2b), "right")
        outs.append(lst[:2])
        # S3: shared left walk of B = [am, bm); 1 sub in A; 1 sub in C
        l0, h0 = init()
        st = bi_walk((l0, h0, l0, h0), bm - am, seed_pos(bm - 1, -1), wchar,
                     "left")
        PA, OA = lane(pa), lane(oa)
        na = PA.shape[1]
        ast = bi_walk(fork(st, na), am, lane_pos(am - 1, -1, na),
                      lambda pos: subbed(wchar(pos), pos, PA, OA), "left")
        nc = len(pc)
        cst = tuple(x[:, :, None].expand(S, na, nc).reshape(S, na * nc)
                    for x in ast)
        PC = lane(np.tile(pc, na))                 # a-major, c-minor lanes
        OC = lane(np.tile(oc, na))
        cst = bi_walk(cst, m - bm, lane_pos(bm, 1, na * nc),
                      lambda pos: subbed(wchar(pos), pos, PC, OC), "right")
        outs.append(cst[:2])
    else:
        raise ValueError(f"budget {budget} not supported (1 or 2)")

    lo = torch.cat([o[0] for o in outs], dim=1)
    hi = torch.maximum(lo, torch.cat([o[1] for o in outs], dim=1))
    valid = full[:, None] & (lo < hi) & (slens > 0)[:, None]
    return lo, hi, valid, w_start
