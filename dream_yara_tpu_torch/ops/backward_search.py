"""Batched exact backward search of seeds in one bin's FM index (counterpart
of dream_yara_tpu/ops/backward_search.py: seed_search, gather_hits and
gather_hit_rows).

All seeds advance in lockstep back-to-front; each trip issues 2S rank
queries (lo and hi bounds in one call). Dead and finished seeds are masked,
never branched on: the search never reads a device value on the host.
"""

from __future__ import annotations

import torch

from .rank import rank_fused


def seed_search(fused: torch.Tensor, counts: torch.Tensor, n,
                reads: torch.Tensor, rows: torch.Tensor, starts: torch.Tensor,
                slens: torch.Tensor, max_seed_len: int,
                pfx_lo: torch.Tensor | None = None,
                pfx_hi: torch.Tensor | None = None, prefix_q: int = 0,
                chars_fe: torch.Tensor | None = None,
                seed_bin: torch.Tensor | None = None):
    """Exact backward search of variable-length seeds cut from the read matrix.

    reads: (R2, L) int8; rows/starts/slens: (S,) int32 — seed s is
    reads[rows[s], starts[s] : starts[s]+slens[s]]; slens == 0 marks an
    invalid seed (empty interval). `n` is the text length (int or 0-d tensor).

    With the q-mer prefix table, seeds whose last q chars are pure ACGT
    start q steps in through one table lookup. The reference then runs its
    remaining trips for those seeds and adds the trips that table-ineligible
    seeds need only when the batch has one; here every trip always runs, so
    the host never waits on the device. A seed that needs no extra trip is
    inactive in them (t + consumed >= slens), so (lo, hi, m_start) are the
    same either way.

    `chars_fe` (optional, (S, max_seed_len) int8): seed chars indexed from
    the seed's end, built without gathers on the uniform-length fast path.

    `seed_bin` (optional, (S,) int32): the flat multi-bin step's per-seed
    bin. The tables are then per-bin stacks — fused (B, nb1, 24), counts
    (B, SIGMA + 1), n (B,), pfx_lo/pfx_hi (B, 4^q) — and seed s reads bin
    seed_bin[s]: its rank rows at bin * nb1 + block of the flattened rows.

    Returns (lo, hi, m_start): (S,) int32 each — the SA interval [lo, hi)
    and the true read-index start of the matched part."""
    S = rows.shape[0]
    L = reads.shape[1]
    dev = rows.device
    flat = reads.reshape(-1)
    row_base = rows.long() * L

    def read_chars(idx):
        return flat[row_base + idx.clamp(0, L - 1).long()].to(torch.int32)

    if seed_bin is None:
        n_vec = torch.as_tensor(n, dtype=torch.int32, device=dev).expand(S)
        rank_base, count_base, pfx_base = None, 0, 0
    else:
        sb = seed_bin.long()
        n_vec = n[sb]
        rb = sb * fused.shape[1]
        rank_base = torch.cat([rb, rb])
        count_base = sb * counts.shape[1]
        pfx_base = 0 if pfx_lo is None else sb * pfx_lo.shape[-1]
        fused = fused.reshape(-1, fused.shape[-1])
    nsig = counts.shape[-1]
    counts = counts.reshape(-1)
    lo = torch.zeros(S, dtype=torch.int32, device=dev)
    hi = torch.where(slens > 0, n_vec, 0)
    consumed0 = torch.zeros(S, dtype=torch.int32, device=dev)

    use_tab = prefix_q > 0 and pfx_lo is not None
    if use_tab:
        q = prefix_q
        m_idx = torch.zeros(S, dtype=torch.int64, device=dev)
        ok_tab = slens >= q
        for t in range(q):
            if chars_fe is not None:
                # from-end index q-1-t, clamped for windows shorter than q
                # (those seeds fail slens >= q either way)
                c = chars_fe[:, min(q - 1 - t, chars_fe.shape[1] - 1)].to(torch.int32)
            else:
                c = read_chars(starts + slens - q + t)
            ok_tab = ok_tab & (c < 4)
            m_idx = (m_idx << 2) | (c & 3).long()
        m_idx = pfx_base + m_idx
        lo = torch.where(ok_tab, pfx_lo.reshape(-1)[m_idx], lo)
        hi = torch.where(ok_tab, pfx_hi.reshape(-1)[m_idx], hi)
        consumed0 = torch.where(ok_tab, q, 0).to(torch.int32)

    for t in range(max_seed_len):
        tt = t + consumed0
        active = tt < slens
        if chars_fe is not None:
            last = chars_fe.shape[1] - 1
            c = chars_fe[:, min(t, last)].to(torch.int32)
            if use_tab:
                cb = chars_fe[:, min(t + prefix_q, last)].to(torch.int32)
                c = torch.where(consumed0 > 0, cb, c)
        else:
            c = read_chars(starts + slens - 1 - tt)
        ranks = rank_fused(fused, c.repeat(2), torch.cat([lo, hi]), rank_base)
        cc = counts[count_base + c.long().clamp(0, nsig - 1)]
        upd = active & (lo < hi)
        lo = torch.where(upd, cc + ranks[:S], lo)
        hi = torch.where(upd, cc + ranks[S:], hi)

    matched = consumed0 + (slens - consumed0).clamp(0, max_seed_len)
    m_start = starts + slens - matched
    return lo, torch.maximum(lo, hi), m_start


def gather_hit_rows(lo: torch.Tensor, hi: torch.Tensor, capacity: int):
    """Like gather_hits, but returns SA ROW indices (0 where ~mask) for a
    sampled SA: the caller locates them (ops/locate.py)."""
    offs = torch.arange(capacity, device=lo.device, dtype=torch.int32)
    rows = lo[:, None] + offs[None, :]
    mask = rows < hi[:, None]
    overflow = (hi - lo - capacity).clamp(min=0)
    return torch.where(mask, rows, 0), mask, overflow


def gather_hits(sa: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                capacity: int, seed_bin: torch.Tensor | None = None):
    """Expand SA intervals into text positions with a per-seed capacity.

    With `seed_bin` (S,), `sa` is the (B, max_sa) stack of the flat
    multi-bin step and seed s reads its bin's row (int64 offsets).

    Returns (positions, mask, overflow):
      positions: (S, capacity) int32 text positions (0 where ~mask)
      mask:      (S, capacity) bool — hit j of seed s is real
      overflow:  (S,) int32 — hits beyond capacity, left to the host pass"""
    offs = torch.arange(capacity, device=lo.device, dtype=torch.int32)
    idx = lo[:, None] + offs[None, :]
    mask = idx < hi[:, None]
    idx = idx.clamp(0, sa.shape[-1] - 1).long()
    if seed_bin is not None:
        idx = (seed_bin.long() * sa.shape[1])[:, None] + idx
    pos = sa.reshape(-1)[idx]
    overflow = (hi - lo - capacity).clamp(min=0)
    return torch.where(mask, pos, 0), mask, overflow
