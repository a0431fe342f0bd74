"""Single-bin device mapping step: seed -> search -> locate -> dedup ->
verify (counterpart of dream_yara_tpu/pipeline/map_step.py).

PyTorch runs eagerly, so there is no jit and no static-shape contract, but
the chunk shapes of the reference are kept because they bound device
memory. The step never reads a device value on the host: every stage is
masked tensor work, and only the caller's drain synchronises. On a sampled
SA the hits are located by the LF walk (ops/locate.py). The multi-bin
edition of this step is pipeline/flat_step.py.

`repetitive_map_step` is the re-seed of rows whose exact seeds overflowed
(sensitivity high/low). It compacts its valid hit lanes before locating
them, so it waits on the device once per call, as its caller does anyway.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.approx_search import seed_search_edits
from ..ops.backward_search import gather_hit_rows, gather_hits, seed_search
from ..ops.banded_verify_cuda import banded_verify
from ..ops.bidir_search import bidir_seed_search
from ..ops.device_index import DeviceFM
from ..ops.locate import locate_sampled_fused
from ..ops.readpack import int32_bits, unpack_blob, unpack_reads
from .seeding import errors_for, make_seeds

PAIR_BLOCK = 64   # pairwise_dedup compares all slot pairs up to this width
PAIR_CHUNK = 32   # ... and blocks of this many slots beyond it


class MapStepOut(NamedTuple):
    row: torch.Tensor        # (Cv,) int32 seq row (0 where ~ok)
    begin: torch.Tensor      # (Cv,) int32 text begin
    end: torch.Tensor        # (Cv,) int32 text end (exclusive)
    dist: torch.Tensor       # (Cv,) int32 edit distance
    ok: torch.Tensor         # (Cv,) bool
    seed_lo: torch.Tensor    # (S,) int32 — SA interval for the overflow pass
    seed_hi: torch.Tensor    # (S,) int32
    overflow: torch.Tensor   # (S,) int32 hits beyond capacity per seed
    m_start: torch.Tensor    # (S,) int32 true read-index start of the matched part
    overflow_total: torch.Tensor  # () int32
    n_spilled: torch.Tensor       # () int32 candidates dropped by compaction;
                                  # > 0 => the host re-runs the chunk densely
    # true lane demands of the flat step, read by the mesh cap tuner: verify
    # lanes wanted (kept + spilled) and locate lanes wanted (sampled SA)
    v_need: torch.Tensor | None = None    # () int32
    loc_need: torch.Tensor | None = None  # () int32


def max_seed_len_static(max_len: int, rate_ppm: int) -> int:
    """Bound on seed length over all read lengths <= max_len."""
    best = 1
    for l in range(1, max_len + 1):
        e = (l * rate_ppm) // 10_000
        best = max(best, l // (e + 1))
    return best


def max_rep_seed_len_static(max_len: int, rate_ppm: int) -> int:
    """Bound on the long seeds of the repetitive path (ceil((E+1)/2) a read)."""
    best = 1
    for l in range(1, max_len + 1):
        e = (l * rate_ppm) // 10_000
        best = max(best, l // max(1, (e + 2) // 2))
    return best


def seed_stop_depth(prefix_q: int) -> int:
    """Truncated-search depth: a seed's last t_stop chars make its SA
    interval tiny; the verifier rejects any false anchor."""
    return prefix_q + 5 if prefix_q > 0 else 16


def _meta_packable(L: int, max_errors: int, R2: int) -> bool:
    return L + 2 * max_errors < 256 and R2 <= (1 << 18) and max_errors <= 31


def uniform_len_ok(lengths, L: int, rate_ppm: int, max_errors: int) -> bool:
    """Host-side eligibility for the gather-free seed-char fast path: every
    read has length exactly L and the static error budget equals L's own."""
    return (bool(np.all(np.asarray(lengths) == L))
            and (L * rate_ppm) // 10_000 == max_errors)


def unbundle_out(bundle: np.ndarray, seed_lo, seed_hi, overflow, m_start,
                 L: int, max_errors: int, R2: int) -> MapStepOut:
    """Host-side inverse of single_bin_map_step_packed's bundle (numpy)."""
    if _meta_packable(L, max_errors, R2):
        cv = (len(bundle) - 2) // 2
        begin = bundle[:cv]
        meta = bundle[cv : 2 * cv].view(np.uint32)
        row = (meta & 0x3FFFF).astype(np.int32)
        dist = ((meta >> 18) & 31).astype(np.int32)
        end = begin + ((meta >> 23) & 255).astype(np.int32)
        ok = (meta >> 31) > 0
        return MapStepOut(row=row, begin=begin, end=end, dist=dist, ok=ok,
                          seed_lo=seed_lo, seed_hi=seed_hi, overflow=overflow,
                          m_start=m_start, overflow_total=bundle[2 * cv],
                          n_spilled=bundle[2 * cv + 1])
    cv = (len(bundle) - 2) // 5
    f = lambda i: bundle[i * cv : (i + 1) * cv]
    return MapStepOut(row=f(0), begin=f(1), end=f(2), dist=f(3),
                      ok=f(4).astype(bool), seed_lo=seed_lo, seed_hi=seed_hi,
                      overflow=overflow, m_start=m_start,
                      overflow_total=bundle[5 * cv],
                      n_spilled=bundle[5 * cv + 1])


def single_bin_map_step_packed(fm: DeviceFM, blob: torch.Tensor, *, half: int,
                               L: int, rate_ppm: int, max_errors: int,
                               capacity: int, max_slen: int,
                               verify_capacity: int | None = None,
                               compact_cap: int | None = None,
                               prefix_q: int = 0, uniform_len: bool = False,
                               sample_rate: int = 1):
    """Packed-upload entry: `blob` is pack_blob_with_lengths output held as
    int32 on the device. Returns (bundle, seed_lo, seed_hi, overflow,
    m_start): every per-candidate output and the two scalars in ONE int32
    tensor, laid out as the reference's (unpack with unbundle_out)."""
    packed, nmask, lengths = unpack_blob(blob, half, L)
    reads = unpack_reads(packed, nmask, lengths, L)
    out = _map_step_core(fm, reads, lengths, rate_ppm, max_errors, capacity,
                         max_slen, verify_capacity, compact_cap, prefix_q,
                         uniform_len, sample_rate)
    if _meta_packable(L, max_errors, half * 2):
        # (row, dist, end-begin, ok) bit-packed into one word next to begin
        delta = (out.end - out.begin).clamp(0, 255).long()
        meta = (out.row.long() | (out.dist.clamp(0, 31).long() << 18)
                | (delta << 23) | (out.ok.long() << 31))
        bundle = torch.cat([out.begin, int32_bits(meta),
                            out.overflow_total[None], out.n_spilled[None]])
    else:
        bundle = torch.cat([out.row, out.begin, out.end, out.dist,
                            out.ok.to(torch.int32), out.overflow_total[None],
                            out.n_spilled[None]])
    return bundle, out.seed_lo, out.seed_hi, out.overflow, out.m_start


def _uniform_seed_chars(reads, L, rate_ppm, max_errors, t_stop, msl_eff):
    """Gather-free (R2 * ns, msl_eff) seed chars from each seed's end, for
    batches where every read has length L: seed k covers
    [k*slen, (k+1)*slen), truncated to its last min(slen, t_stop) chars.
    Padding rows get garbage chars; their seeds carry slens == 0."""
    R2 = reads.shape[0]
    ns = max_errors + 1
    slen = L // ns
    slen_eff = min(slen, t_stop)
    cols = []
    for k in range(ns):
        a = k * slen + (slen - slen_eff)
        w = reads[:, a : a + slen_eff].flip(1)
        if slen_eff < msl_eff:
            w = torch.nn.functional.pad(w, (0, msl_eff - slen_eff), value=4)
        cols.append(w)
    return torch.stack(cols, dim=1).reshape(R2 * ns, msl_eff)


def _map_step_core(fm: DeviceFM, reads, lengths, rate_ppm, max_errors, capacity,
                   max_slen, verify_capacity, compact_cap, prefix_q,
                   uniform_len=False, sample_rate: int = 1) -> MapStepOut:
    R2, L = reads.shape
    rows, starts, slens = make_seeds(lengths, R2, rate_ppm, max_errors)
    # truncated search: match only each seed's last t_stop chars
    t_stop = seed_stop_depth(prefix_q)
    slens_eff = torch.clamp(slens, max=t_stop)
    starts_eff = starts + (slens - slens_eff)
    msl_eff = min(max_slen, t_stop)
    chars_fe = (_uniform_seed_chars(reads, L, rate_ppm, max_errors, t_stop,
                                    msl_eff)
                if uniform_len else None)
    lo, hi, m_start = seed_search(fm.fused, fm.counts, fm.n, reads, rows,
                                  starts_eff, slens_eff, msl_eff,
                                  pfx_lo=fm.pfx_lo, pfx_hi=fm.pfx_hi,
                                  prefix_q=prefix_q, chars_fe=chars_fe)
    if sample_rate > 1:
        # sampled SA: hit rows, then the LF walk to marked rows on the fused
        # rows (the raw bwt/occ walk lost matches in the reference, map_step.py)
        sa_rows, hmask, overflow = gather_hit_rows(lo, hi, capacity)
        pos = locate_sampled_fused(
            fm.fused, fm.counts, fm.sa_mark_bits, fm.sa_rank_ck, fm.sa,
            sa_rows.reshape(-1), sample_rate,
            valid=hmask.reshape(-1)).reshape(sa_rows.shape)
    else:
        pos, hmask, overflow = gather_hits(fm.sa, lo, hi, capacity)

    ns = max_errors + 1
    A = (pos - m_start[:, None]).reshape(R2, ns * capacity)
    V = hmask.reshape(R2, ns * capacity)
    row_ids = torch.arange(R2, device=reads.device, dtype=torch.int32)
    if compact_cap is not None:
        keep2 = pairwise_dedup(A, V)
        vrow, vanch, keep, n_spilled = global_compact(A, keep2, row_ids,
                                                      compact_cap)
    else:
        vrow, vanch, keep, n_spilled = dedup_compact(A, V, row_ids,
                                                     verify_capacity)
    dist, beg, end, ok = verify_candidates(fm, reads, lengths, vrow, vanch,
                                           keep, rate_ppm, max_errors)
    return MapStepOut(row=vrow, begin=beg, end=end, dist=dist, ok=ok,
                      seed_lo=lo, seed_hi=hi, overflow=overflow,
                      m_start=m_start,
                      overflow_total=overflow.sum(dtype=torch.int32),
                      n_spilled=n_spilled)


def pairwise_dedup(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Keep mask after removing duplicate anchors within each row: lane j
    is dropped when an earlier valid lane k < j of its row has its anchor."""
    R, slots = A.shape
    if slots <= PAIR_BLOCK:
        earlier = torch.ones((slots, slots), dtype=torch.bool,
                             device=A.device).tril(-1)
        eq = A[:, :, None] == A[:, None, :]
        dup = (eq & V[:, None, :] & earlier[None]).any(dim=2)
        return V & ~dup
    # wide rows: one (R, PAIR_CHUNK, slots) block at a time bounds memory
    col = torch.arange(slots, device=A.device)
    dups = []
    for j0 in range(0, slots, PAIR_CHUNK):
        Aj = A[:, j0 : j0 + PAIR_CHUNK]
        earlier = col[None, :] < torch.arange(j0, j0 + Aj.shape[1],
                                              device=A.device)[:, None]
        eq = Aj[:, :, None] == A[:, None, :]
        dups.append((eq & V[:, None, :] & earlier[None]).any(dim=2))
    return V & ~torch.cat(dups, dim=1)


def global_compact(A: torch.Tensor, V: torch.Tensor, row_ids: torch.Tensor,
                   cap2: int):
    """Cross-row compaction of kept lanes into one global budget of cap2.

    Each row with kept lanes writes its index at its first output slot (an
    exclusive cumsum of the per-row counts); a running max fills the slots
    in between, and each slot picks the kept lane of its row whose rank
    within the row is the slot's offset. Lanes beyond cap2 are counted in
    n_spilled (the host re-runs the chunk densely).

    A, V: (R, slots); row_ids: (R,). Returns (vrow, vanch, keep2, n_spilled)
    with (cap2,) shapes and zeros beyond the kept lanes."""
    R, slots = A.shape
    dev = A.device
    cnt = V.sum(dim=1, dtype=torch.int32)
    incl = torch.cumsum(cnt, 0, dtype=torch.int32)
    off = incl - cnt
    total = incl[-1] if R > 0 else torch.zeros((), dtype=torch.int32, device=dev)
    # rows whose first slot lies beyond cap2 write into a dump slot, dropped
    dst = torch.where((cnt > 0) & (off < cap2), off, cap2).long()
    starts = torch.zeros(cap2 + 1, dtype=torch.int32, device=dev)
    starts[dst] = torch.arange(R, dtype=torch.int32, device=dev)
    rowp = torch.cummax(starts[:cap2], dim=0).values.long().clamp(0, max(R - 1, 0))
    j = torch.arange(cap2, dtype=torch.int32, device=dev) - off[rowp]
    keepr = V[rowp]                                          # (cap2, slots)
    within = torch.cumsum(keepr, dim=1, dtype=torch.int32)
    # first lane whose running count reaches j+1 (a kept lane, since the
    # count steps by one exactly at kept lanes)
    slot = (within < (j + 1)[:, None]).sum(dim=1).clamp(max=slots - 1)
    vanch = A[rowp, slot]
    keep2 = torch.arange(cap2, dtype=torch.int32, device=dev) < torch.clamp(total, max=cap2)
    vrow = torch.where(keep2, row_ids[rowp], 0)
    n_spilled = torch.clamp(total - cap2, min=0)
    return vrow, torch.where(keep2, vanch, 0), keep2, n_spilled


def dedup_compact(A: torch.Tensor, V: torch.Tensor, row_ids: torch.Tensor,
                  verify_capacity: int | None):
    """Per-row anchor dedup, then (when verify_capacity < slots) keep each
    row's first verify_capacity kept lanes; the rest count as spilled.

    Returns (vrow, vanch, keep) flattened (R * kv,) + n_spilled scalar."""
    R, slots = A.shape
    keep2 = pairwise_dedup(A, V)
    kept_before = keep2.sum(dtype=torch.int32)
    if verify_capacity is not None and verify_capacity < slots:
        kv = verify_capacity
        picked_a, picked_k = [], []
        kw = keep2
        col = torch.arange(slots, device=A.device)[None, :]
        for _ in range(kv):
            # first kept slot (slots - 1 when none is left: then got is False)
            idx = (torch.cumsum(kw, dim=1) == 0).sum(dim=1).clamp(max=slots - 1)
            got = kw.gather(1, idx[:, None])[:, 0]
            a = A.gather(1, idx[:, None])[:, 0]
            picked_a.append(torch.where(got, a, 0))
            picked_k.append(got)
            kw = kw & (col != idx[:, None])
        Am = torch.stack(picked_a, dim=1)
        keep2 = torch.stack(picked_k, dim=1)
    else:
        kv = slots
        Am = torch.where(keep2, A, 0)
    n_spilled = kept_before - keep2.sum(dtype=torch.int32)
    keep = keep2.reshape(-1)
    vrow = row_ids.repeat_interleave(kv)
    vanch = Am.reshape(-1)
    return (torch.where(keep, vrow, 0), torch.where(keep, vanch, 0),
            keep, n_spilled)


def verify_candidates(fm: DeviceFM, reads, lengths, vrow, vanch, keep,
                      rate_ppm: int, max_errors: int):
    n_reads = lengths.shape[0]
    lrow = lengths[(vrow % n_reads).long()].to(torch.int32)
    dist, beg, end = banded_verify(fm.text, vanch.contiguous(), reads, vrow,
                                   lrow, max_errors)
    budget = errors_for(lrow, rate_ppm)
    ok = keep & (dist <= budget) & (beg >= 0) & (end <= fm.n)
    return dist, beg, end, ok


def verify_positions(fm: DeviceFM, reads, lengths, rows, anchors, mask, *,
                     max_errors: int):
    """Verify explicit (row, anchor) candidates (the overflow fallback)."""
    n_reads = lengths.shape[0]
    vrow = torch.where(mask, rows, 0)
    lrow = lengths[(vrow % n_reads).long()].to(torch.int32)
    return banded_verify(fm.text, torch.where(mask, anchors, 0), reads, vrow,
                         lrow, max_errors)


def compact_hits(k: torch.Tensor, j: torch.Tensor, a: torch.Tensor,
                 row_ids: torch.Tensor, slots: int,
                 verify_capacity: int | None):
    """dedup_compact's output from the valid lanes alone.

    k, j, a: (N,) row, slot and anchor of each valid lane, in (row, slot)
    order; row_ids: (K,). A lane is dropped when an earlier lane of its row
    has its anchor (a stable sort on (row, anchor) finds the first); each
    row keeps its first verify_capacity kept lanes in slot order, the rest
    count as spilled. Returns (vrow, vanch, keep) of (K * kv,) and n_spilled,
    laid out as dedup_compact's."""
    K = row_ids.shape[0]
    dev = row_ids.device
    kv = (slots if verify_capacity is None or verify_capacity >= slots
          else verify_capacity)
    k = k.long()
    key = (k << 32) | (a.long() & 0xFFFFFFFF)
    order = torch.sort(key, stable=True).indices
    ks = key[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    keep = torch.empty_like(first)
    keep[order] = first
    per_row = torch.zeros(K, dtype=torch.int64, device=dev).index_add_(
        0, k, keep.long())
    rank = torch.cumsum(keep.long(), 0) - 1 - (torch.cumsum(per_row, 0) - per_row)[k]
    if kv == slots:
        sel, dest = keep, k * slots + j.long()
    else:
        sel, dest = keep & (rank < kv), k * kv + rank
    dest = torch.where(sel, dest, K * kv)                  # dump slot, dropped
    vanch = torch.zeros(K * kv + 1, dtype=torch.int32, device=dev)
    vanch[dest] = a.to(torch.int32)
    kept = torch.zeros(K * kv + 1, dtype=torch.bool, device=dev)
    kept[dest] = True
    vanch, kept = vanch[:-1], kept[:-1]
    n_spilled = (keep.sum() - sel.sum()).to(torch.int32)
    vrow = row_ids.repeat_interleave(kv)
    return (torch.where(kept, vrow, 0), torch.where(kept, vanch, 0), kept,
            n_spilled)


def repetitive_map_step(fm: DeviceFM, reads: torch.Tensor,
                        lengths: torch.Tensor, rep_rows: torch.Tensor,
                        rep_mask: torch.Tensor, *, rate_ppm: int,
                        max_errors: int, capacity: int, max_slen_rep: int,
                        verify_capacity: int = 8, budget: int = 1,
                        indels: bool = False, backend: str = "enum",
                        sample_rate: int = 1):
    """Re-seed repetitive rows with fewer, longer approximate seeds.

    Rows whose exact seeds overflowed capacity get s' = ceil((E+1) /
    (budget+1)) seeds of length l // s', searched with up to `budget`
    edits (pigeonhole keeps the error budget covered): by layout
    enumeration (`enum`, substitutions and with `indels` one indel too) or
    by search schemes on the bidirectional index (`bidir`, substitutions
    only; the caller guarantees full windows and fm.rfused). Each seed
    layout's SA interval yields up to `capacity` hits, located on the
    full or the sampled SA, then deduplicated per row and verified.

    rep_rows: (K,) seq-row ids; rep_mask: (K,) bool.
    Returns (row, begin, end, dist, ok, n_spilled)."""
    K = rep_rows.shape[0]
    n_reads = lengths.shape[0]
    dev = rep_rows.device

    l = lengths[(rep_rows % n_reads).long()].to(torch.int32)
    l = torch.where(rep_mask, l, 0)
    e = errors_for(l, rate_ppm).to(torch.int32)
    ns2 = (e + budget + 1) // (budget + 1)               # ceil((E+1)/(budget+1))
    ns2_max = (max_errors + budget + 1) // (budget + 1)

    rows_s = rep_rows.repeat_interleave(ns2_max)
    sidx = torch.arange(ns2_max, device=dev, dtype=torch.int32).repeat(K)
    l_s = l.repeat_interleave(ns2_max)
    ns2_s = ns2.repeat_interleave(ns2_max)
    slen = torch.where(ns2_s > 0, l_s // ns2_s.clamp(min=1), 0)
    starts = sidx * slen
    slens = torch.where(sidx < ns2_s, slen, 0)

    if backend == "bidir":
        lo, hi, lvalid, w_start = bidir_seed_search(
            fm.fused, fm.counts, fm.rfused, fm.counts, fm.n, reads, rows_s,
            starts, slens, max_slen_rep, budget=budget)
    else:
        lo, hi, lvalid, w_start = seed_search_edits(
            fm.fused, fm.counts, fm.n, reads, rows_s, starts, slens,
            max_slen_rep, budget=budget, indels=indels)
    hi = torch.where(lvalid, hi, lo)

    # slot j of row k is ((seed * NL) + layout) * capacity + hit; only the
    # valid slots are located (the one wait of this step)
    NL = lo.shape[1]
    slots = ns2_max * NL * capacity
    _, hmask, _ = gather_hit_rows(lo.reshape(-1), hi.reshape(-1), capacity)
    k, j = hmask.reshape(K, slots).nonzero(as_tuple=True)
    lane = k * (ns2_max * NL) + torch.div(j, capacity, rounding_mode="floor")
    sa_rows = lo.reshape(-1)[lane] + (j % capacity).to(torch.int32)
    if sample_rate > 1:
        pos = locate_sampled_fused(fm.fused, fm.counts, fm.sa_mark_bits,
                                   fm.sa_rank_ck, fm.sa, sa_rows, sample_rate)
    else:
        pos = fm.sa[sa_rows.long()]
    # anchor = window begin in the text; an indel layout shifts the
    # window's end by one, which the verifier's band absorbs
    anchors = pos - w_start[torch.div(lane, NL, rounding_mode="floor")]
    vrow, vanch, keep, n_spilled = compact_hits(
        k, j, anchors, torch.where(rep_mask, rep_rows, 0), slots,
        verify_capacity)
    dist, beg, end, ok = verify_candidates(fm, reads, lengths, vrow, vanch,
                                           keep, rate_ppm, max_errors)
    return vrow, beg, end, dist, ok, n_spilled
