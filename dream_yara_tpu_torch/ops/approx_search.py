"""Approximate seed search (<= 2 edits) by dense layout enumeration — the
repetitive re-seed path (counterpart of dream_yara_tpu/ops/approx_search.py).

Every explicit placement of <= budget edits in a seed's matched window is
one lane of an (S, NL) matrix; a lane's character at each step is derived
arithmetically from its layout (kind, p1, a1, p2, a2). On the CPU the plain
edition advances all lanes in one lockstep backward search, 2 * S * NL rank
queries a trip. On a card one launch of csrc/approx_search.cu computes the
same intervals: each lane starts from the exact lane's interval at its
first edit (`layout_branch`) and stops once its interval is empty.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import approx_search_cuda
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


def lockstep_rank_rows(n_seeds: int, m: int, budget: int, indels: bool) -> int:
    """Rank rows the plain edition fetches for n_seeds seeds: two a lane a
    trip, every lane at every trip."""
    NL = len(_layout_tables(m, budget, indels)[0])
    return 2 * n_seeds * NL * (m + int(indels))


def layout_branch(kind: np.ndarray, p1: np.ndarray, p2: np.ndarray):
    """Per layout, (back, dlen): a lane reads the exact lane's chars at
    every step before eff - back, its branch step (its first edit: the step
    that reads the substituted char, the deleted char's neighbour or the
    inserted char), and runs eff + dlen steps. The exact lane branches at
    eff, so it starts from its own final interval."""
    sub = np.where(kind == 4, np.maximum(p1, p2), p1) + 1
    back = np.where((kind == 1) | (kind == 2) | (kind == 4), sub,
                    np.where(kind == 3, p1, 0))
    dlen = np.where(kind == 2, -1, np.where(kind == 3, 1, 0))
    return back.astype(np.int32), dlen.astype(np.int32)


_device_layouts: dict = {}
_device_layouts_lock = threading.Lock()


def device_layouts(m: int, budget: int, indels: bool,
                   device: torch.device) -> torch.Tensor:
    """The kernel's (7, NL) int32 tables on `device` (kind, p1, a1, p2, a2,
    back, dlen), made once per shape and device."""
    key = (m, budget, bool(indels), torch.device(device))
    with _device_layouts_lock:
        t = _device_layouts.get(key)
        if t is None:
            kind, p1, a1, p2, a2 = _layout_tables(m, budget, indels)
            tables = np.stack([kind, p1, a1, p2, a2,
                               *layout_branch(kind, p1, p2)])
            t = _device_layouts[key] = torch.from_numpy(tables).to(device)
        return t


def _lane_len(eff: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """Steps each lane runs: a deletion matches m - 1 chars, an insertion
    m + 1."""
    return eff + torch.where(kind == 2, -1, torch.where(kind == 3, 1, 0))


def _lane_step(flat, row_base, w_start, eff, t: int, L: int,
               kind, p1, a1, p2, a2):
    """The window index and the char every lane reads at step t:
    window-relative index eff-1-t for exact and substitution lanes; a
    deletion skips p1; an insertion consumes its inserted char at
    t == eff - p1. Returns (idx, c), (S, NL) each."""
    base = eff - 1 - t
    idx = torch.where(kind == 2,
                      torch.where(t < eff - 1 - p1, base, base - 1),
                      torch.where(kind == 3,
                                  torch.where(t < eff - p1, base, base + 1),
                                  base))
    is_ins_step = (kind == 3) & (t == eff - p1)
    ridx = (w_start[:, None] + idx).clamp(0, L - 1)
    c = flat[row_base + ridx.long()].to(torch.int32)
    # substitutions replace ACGT only (N stays literal, as in the exact
    # search)
    acgt = c < 4
    c = torch.where((kind == 1) & (idx == p1) & acgt, (c + a1) % 4, c)
    c = torch.where((kind == 4) & (idx == p1) & acgt, (c + a1) % 4, c)
    c = torch.where((kind == 4) & (idx == p2) & acgt, (c + a2) % 4, c)
    return idx, torch.where(is_ins_step, a1, c)


def seed_search_edits(fused: torch.Tensor, counts: torch.Tensor, n,
                      reads: torch.Tensor, rows: torch.Tensor,
                      starts: torch.Tensor, slens: torch.Tensor,
                      max_slen: int, *, budget: int = 1, indels: bool = False,
                      rank_rows: torch.Tensor | None = None):
    """SA intervals of every <= budget-edit layout of each seed's last
    min(slens, max_slen) chars.

    reads: (R2, L) int8; rows/starts/slens: (S,) int32 (slens == 0: no
    seed). Returns (lo, hi, valid, w_start): (S, NL) int32 intervals and
    their validity, and the (S,) read index where each matched window
    begins (anchor = text position - w_start; an indel layout shifts the
    window's end by one, which the verifier's band absorbs).

    CPU tensors run the plain edition; CUDA tensors launch the kernel (no
    fallback between them). `rank_rows`, a one-element int64 tensor on the
    same device, gets the rank rows fetched added to it."""
    if rows.device.type == "cpu":
        return _seed_search_edits_plain(fused, counts, n, reads, rows, starts,
                                        slens, max_slen, budget=budget,
                                        indels=indels, rank_rows=rank_rows)
    m = int(max_slen)
    n_t = torch.as_tensor(n, dtype=torch.int32, device=rows.device).reshape(())
    return approx_search_cuda.kernel(
        fused, counts, n_t, reads, rows, starts, slens, m,
        device_layouts(m, budget, indels, rows.device), rank_rows)


def _seed_search_edits_plain(fused, counts, n, reads, rows, starts, slens,
                             max_slen: int, *, budget: int = 1,
                             indels: bool = False, rank_rows=None):
    """The plain edition of `seed_search_edits`: every lane advances in one
    lockstep backward search, each trip 2 * S * NL rank queries through the
    fused rows."""
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
    lane_len = _lane_len(eff, kind)
    # layouts whose edit positions fall outside a short window duplicate
    # smaller layouts
    lvalid = ((slens > 0)[:, None] & (p1 < eff.clamp(min=1))
              & ((kind != 4) | (p2 < eff)) & ((kind != 3) | (p1 < eff)))

    lo = torch.zeros((S, NL), dtype=torch.int32, device=dev)
    n_t = torch.as_tensor(n, dtype=torch.int32, device=dev)
    hi = torch.where(lvalid, n_t, 0).to(torch.int32)
    row_base = rows.long()[:, None] * L
    trips = m + (1 if indels else 0)
    for t in range(trips):
        active = t < lane_len
        _, c = _lane_step(flat, row_base, w_start, eff, t, L,
                          kind, p1, a1, p2, a2)
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
    if rank_rows is not None:
        rank_rows += 2 * S * NL * trips
    hi = torch.maximum(lo, hi)
    valid = lvalid & (lo < hi) & (lane_len > 0)
    return lo, hi, valid, w_start
