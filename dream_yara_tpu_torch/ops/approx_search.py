"""Approximate seed search (<= 2 edits) by dense layout enumeration — the
repetitive re-seed path (counterpart of dream_yara_tpu/ops/approx_search.py).

Every explicit placement of <= budget edits in a seed's matched window is
one lane of an (S, NL) matrix, and all lanes advance in one lockstep
backward search; a lane's character at each step is derived arithmetically
from its layout (kind, p1, a1, p2, a2). Each trip issues 2 * S * NL rank
queries through the fused rows (the row-gather kernel on a card).
"""

from __future__ import annotations

import numpy as np
import torch

from .rank import rank_fused


def _layout_tables(m: int, budget: int, indels: bool):
    """Layouts of <= budget edits in a window of m chars, as five int32
    arrays (kind, p1, a1, p2, a2):
      kind 0: exact
      kind 1: substitution at p1, char (seed[p1] + a1) % 4, a1 in {1, 2, 3}
      kind 2: deletion of seed char p1 (the text matched is m - 1 long)
      kind 3: insertion of char a1 in {0..3} before seed position p1 > 0
      kind 4: two substitutions p1 < p2 with offsets a1, a2   [budget 2]
    Indels come with budget 1 only; budget 2 enumerates substitution pairs."""
    kinds, p1s, a1s, p2s, a2s = [0], [0], [0], [0], [0]

    def add(kind, p1, a1, p2=0, a2=0):
        kinds.append(kind); p1s.append(p1); a1s.append(a1)
        p2s.append(p2); a2s.append(a2)

    for p in range(m):
        for o in (1, 2, 3):
            add(1, p, o)
    if indels:
        for p in range(m):
            add(2, p, 0)
        for p in range(1, m):          # interior gaps only
            for c in range(4):
                add(3, p, c)
    if budget >= 2:
        for p1 in range(m):
            for p2 in range(p1 + 1, m):
                for o1 in (1, 2, 3):
                    for o2 in (1, 2, 3):
                        add(4, p1, o1, p2, o2)
    f = lambda x: np.asarray(x, dtype=np.int32)
    return f(kinds), f(p1s), f(a1s), f(p2s), f(a2s)


def seed_search_edits(fused: torch.Tensor, counts: torch.Tensor, n,
                      reads: torch.Tensor, rows: torch.Tensor,
                      starts: torch.Tensor, slens: torch.Tensor,
                      max_slen: int, *, budget: int = 1, indels: bool = False):
    """SA intervals of every <= budget-edit layout of each seed's last
    min(slens, max_slen) chars.

    reads: (R2, L) int8; rows/starts/slens: (S,) int32 (slens == 0: no
    seed). Returns (lo, hi, valid, w_start): (S, NL) int32 intervals and
    their validity, and the (S,) read index where each matched window
    begins (anchor = text position - w_start; an indel layout shifts the
    window's end by one, which the verifier's band absorbs)."""
    S = rows.shape[0]
    L = reads.shape[1]
    m = int(max_slen)
    dev = rows.device
    flat = reads.reshape(-1)
    kind, p1, a1, p2, a2 = (torch.from_numpy(x).to(dev)[None, :]
                            for x in _layout_tables(m, budget, indels))
    NL = kind.shape[1]

    eff = slens.clamp(max=m)[:, None]                 # matched window length
    w_start = starts + slens - eff[:, 0]              # window begin in read
    lane_len = eff + torch.where(kind == 2, -1, torch.where(kind == 3, 1, 0))
    # layouts whose edit positions fall outside a short window duplicate
    # smaller layouts
    lvalid = ((slens > 0)[:, None] & (p1 < eff.clamp(min=1))
              & ((kind != 4) | (p2 < eff)) & ((kind != 3) | (p1 < eff)))

    lo = torch.zeros((S, NL), dtype=torch.int32, device=dev)
    n_t = torch.as_tensor(n, dtype=torch.int32, device=dev)
    hi = torch.where(lvalid, n_t, 0).to(torch.int32)
    row_base = rows.long()[:, None] * L
    for t in range(m + (1 if indels else 0)):
        active = t < lane_len
        # window-relative read index consumed at step t: exact and
        # substitution lanes read eff-1-t; a deletion skips p1; an
        # insertion consumes its inserted char at t == eff - p1
        base = eff - 1 - t
        idx = torch.where(kind == 2,
                          torch.where(t < eff - 1 - p1, base, base - 1),
                          torch.where(kind == 3,
                                      torch.where(t < eff - p1, base, base + 1),
                                      base))
        is_ins_step = (kind == 3) & (t == eff - p1)
        ridx = (w_start[:, None] + idx).clamp(0, L - 1)
        c = flat[row_base + ridx.long()].to(torch.int32)
        # substitutions replace ACGT only (N stays literal, as in the
        # exact search)
        acgt = c < 4
        c = torch.where((kind == 1) & (idx == p1) & acgt, (c + a1) % 4, c)
        c = torch.where((kind == 4) & (idx == p1) & acgt, (c + a1) % 4, c)
        c = torch.where((kind == 4) & (idx == p2) & acgt, (c + a2) % 4, c)
        c = torch.where(is_ins_step, a1, c)

        cf = c.reshape(-1)
        ranks = rank_fused(fused, cf.repeat(2),
                           torch.cat([lo.reshape(-1), hi.reshape(-1)]))
        cc = counts[cf.long()]
        Q = S * NL
        nlo = (cc + ranks[:Q]).reshape(S, NL)
        nhi = (cc + ranks[Q:]).reshape(S, NL)
        upd = active & (lo < hi)
        lo = torch.where(upd, nlo, lo)
        hi = torch.where(upd, nhi, hi)
    hi = torch.maximum(lo, hi)
    valid = lvalid & (lo < hi) & (lane_len > 0)
    return lo, hi, valid, w_start
