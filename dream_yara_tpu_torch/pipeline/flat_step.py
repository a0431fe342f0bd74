"""Flat multi-bin map step: one pass over a shared slot pool (counterpart of
dream_yara_tpu/pipeline/flat_step.py).

The per-bin path runs one padded map step per routed bin, so its work grows
with the number of bins times the hottest bin's load. Here all routed
(read, bin) pairs of a batch are compacted into one pool of t_cap slots, in
bin-major order, and mapped in one step over the stacked per-bin tables
(ops/device_index.py::DeviceFMSet): every table read adds the slot's bin
offset (rank rows, counts, q-mer table, SA, locate tables, text). Slot work
follows the routed pairs, whatever the skew.

Slot rows are laid out [T fwd | T rc]; row -> (slot = row % T, strand =
row // T), as in the single-bin step. Nothing here reads a device value on
the host: the pool is a cumsum and a scatter, the locate compaction and the
verify compaction the same, so the step never synchronises.
"""

from __future__ import annotations

import os

import torch

from ..ops.backward_search import gather_hit_rows, gather_hits, seed_search
from ..ops.banded_verify_cuda import banded_verify
from ..ops.device_index import DeviceFMSet
from ..ops.locate import locate_sampled_fused
from .map_step import (MapStepOut, _uniform_seed_chars, global_compact,
                       pairwise_dedup, seed_stop_depth)
from .seeding import errors_for, make_seeds


def _row_starts(cnt: torch.Tensor, cap: int):
    """Lay rows of `cnt` lanes each into one budget of `cap` slots, in row
    order: returns (incl, off, rowp), the inclusive and exclusive cumsums
    of the counts and the row of each slot (a row with lanes writes its
    index at its first slot, a running max fills the rest)."""
    incl = torch.cumsum(cnt, 0, dtype=torch.int32)
    off = incl - cnt
    dst = torch.where((cnt > 0) & (off < cap), off, cap).long()
    starts = torch.zeros(cap + 1, dtype=torch.int32, device=cnt.device)
    starts[dst] = torch.arange(cnt.shape[0], dtype=torch.int32, device=cnt.device)
    return incl, off, torch.cummax(starts[:cap], dim=0).values.long()


def slot_pool(cand_local: torch.Tensor, t_cap: int):
    """Compact routed (read, bin) pairs into t_cap shared slots.

    cand_local: (n_loc, B) bool routing of this device's reads and bins.
    Bin-major order (all of bin 0's reads, then bin 1's, ...), which the
    host rebuilds from the routing bits. Returns (read_slot, bin_slot,
    valid, n_overflow): (t_cap,) int32, int32, bool and the () int32 count
    of pairs beyond t_cap (drained by the host in another pass)."""
    n_loc = cand_local.shape[0]
    dev = cand_local.device
    flat = cand_local.t().reshape(-1)
    pos = torch.cumsum(flat.to(torch.int32), 0, dtype=torch.int32) - 1
    total = (pos[-1] + 1 if flat.shape[0] > 0
             else torch.zeros((), dtype=torch.int32, device=dev))
    dst = torch.where(flat & (pos < t_cap), pos, t_cap).long()
    src = torch.zeros(t_cap + 1, dtype=torch.int32, device=dev)
    src[dst] = torch.arange(flat.shape[0], dtype=torch.int32, device=dev)
    src = src[:t_cap]
    valid = torch.arange(t_cap, dtype=torch.int32, device=dev) < torch.clamp(
        total, max=t_cap)
    return (src % max(n_loc, 1), torch.div(src, max(n_loc, 1), rounding_mode="floor"),
            valid, torch.clamp(total - t_cap, min=0))


def flat_map_step(fmset: DeviceFMSet, reads2: torch.Tensor,
                  lengths: torch.Tensor, read_slot, bin_slot, valid, *,
                  half_loc: int, rate_ppm: int, max_errors: int,
                  capacity: int, max_slen: int, prefix_q: int,
                  compact_cap: int, uniform_len: bool, sample_rate: int = 1,
                  cap2l: float | None = None) -> MapStepOut:
    """Map every slot against its own bin in one step.

    fmset: the stacked per-bin tables; reads2: (2 * half_loc, L) int8
    [fwd | rc] rows of the batch; lengths: (half_loc,) int32; the slot
    arrays from slot_pool. `cap2l` sizes the sampled-SA locate budget as a
    multiple of the pool (DY_CAP2L, default 4.0). Returns the MapStepOut of
    the 2T slot rows, its v_need and loc_need filled."""
    sub_reads = torch.cat([reads2[read_slot.long()],
                           reads2[half_loc + read_slot.long()]])        # (2T, L)
    sub_reads = torch.where(valid.repeat(2)[:, None], sub_reads, 4).to(torch.int8)
    sub_lens = torch.where(valid, lengths[read_slot.long()], 0).to(torch.int32)
    return _flat_core(fmset, sub_reads, sub_lens, bin_slot, rate_ppm,
                      max_errors, capacity, max_slen, compact_cap, prefix_q,
                      uniform_len, sample_rate, cap2l)


def _flat_core(fmset: DeviceFMSet, reads, lengths, bin_slot, rate_ppm,
               max_errors, capacity, max_slen, compact_cap, prefix_q,
               uniform_len, sample_rate, cap2l) -> MapStepOut:
    """The single-bin map step's stages with a bin per seed and per lane."""
    R2, L = reads.shape
    dev = reads.device
    ns = max_errors + 1
    bin_row = bin_slot.repeat(2)                                  # (2T,)
    bin_seed = bin_row.repeat_interleave(ns)                      # (S,)

    rows, starts, slens = make_seeds(lengths, R2, rate_ppm, max_errors)
    t_stop = seed_stop_depth(prefix_q)
    slens_eff = torch.clamp(slens, max=t_stop)
    starts_eff = starts + (slens - slens_eff)
    msl_eff = min(max_slen, t_stop)
    chars_fe = (_uniform_seed_chars(reads, L, rate_ppm, max_errors, t_stop,
                                    msl_eff)
                if uniform_len else None)
    use_pfx = prefix_q > 0 and fmset.pfx_lo is not None
    lo, hi, m_start = seed_search(
        fmset.fused, fmset.counts, fmset.n, reads, rows, starts_eff, slens_eff,
        msl_eff, pfx_lo=fmset.pfx_lo if use_pfx else None,
        pfx_hi=fmset.pfx_hi if use_pfx else None,
        prefix_q=prefix_q if use_pfx else 0, chars_fe=chars_fe,
        seed_bin=bin_seed)

    if sample_rate > 1:
        # compact the valid hit lanes into loc_cap lanes BEFORE the LF walk
        # (only a few percent of the S * capacity lanes are hits); the
        # valid lanes of a seed are a prefix, so each seed writes its first
        # lane's slot and a running max fills the rest. Seeds whose lanes
        # end past loc_cap count as overflowed: the host re-maps their reads
        S = lo.shape[0]
        sa_rows, hmask, overflow = gather_hit_rows(lo, hi, capacity)
        if cap2l is None:
            cap2l = float(os.environ.get("DY_CAP2L", "4.0"))
        loc_cap = max(8, int(cap2l * (R2 // 2)))
        cnt = torch.clamp(hi - lo, 0, capacity).to(torch.int32)
        incl, off, rowp = _row_starts(cnt, loc_cap)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        loc_need = incl[-1] if S > 0 else zero
        overflow = overflow + (incl > loc_cap).to(overflow.dtype)
        slot_i = torch.arange(loc_cap, dtype=torch.int32, device=dev)
        lane = slot_i - off[rowp]
        src = torch.clamp(rowp * capacity + lane, 0, S * capacity - 1)
        valid_c = slot_i < torch.clamp(loc_need, max=loc_cap)
        pos_c = locate_sampled_fused(
            fmset.fused, fmset.counts, fmset.sa_mark_bits, fmset.sa_rank_ck,
            fmset.sa, sa_rows.reshape(-1)[src], sample_rate, valid=valid_c,
            lane_bin=bin_seed[rowp])
        # back into the dense (S, capacity) lane layout; lanes past loc_cap
        # are dropped here and counted in `overflow` above
        pos = torch.zeros(S * capacity + 1, dtype=torch.int32, device=dev)
        pos[torch.where(valid_c, src, S * capacity)] = pos_c
        pos = pos[:-1].reshape(S, capacity)
        lane_pos = off[:, None] + torch.arange(capacity, dtype=torch.int32,
                                               device=dev)[None, :]
        hmask = hmask & (lane_pos < loc_cap)
    else:
        loc_need = torch.zeros((), dtype=torch.int32, device=dev)
        pos, hmask, overflow = gather_hits(fmset.sa, lo, hi, capacity,
                                           seed_bin=bin_seed)

    A = (pos - m_start[:, None]).reshape(R2, ns * capacity)
    V = hmask.reshape(R2, ns * capacity)
    row_ids = torch.arange(R2, dtype=torch.int32, device=dev)
    keep2 = pairwise_dedup(A, V)
    vrow, vanch, keep, n_spilled = global_compact(A, keep2, row_ids,
                                                  compact_cap)

    # verify each lane in its own bin's text row
    bin_lane = bin_row[vrow.long()]
    lrow = lengths[(vrow % lengths.shape[0]).long()].to(torch.int32)
    dist, beg, end = banded_verify(fmset.text, vanch.contiguous(), reads, vrow,
                                   lrow, max_errors, lane_bin=bin_lane,
                                   bin_n=fmset.n)
    budget = errors_for(lrow, rate_ppm)
    ok = keep & (dist <= budget) & (beg >= 0) & (end <= fmset.n[bin_lane.long()])
    return MapStepOut(row=vrow, begin=beg, end=end, dist=dist, ok=ok,
                      seed_lo=lo, seed_hi=hi, overflow=overflow,
                      m_start=m_start,
                      overflow_total=overflow.sum(dtype=torch.int32),
                      n_spilled=n_spilled,
                      v_need=n_spilled + keep.sum(dtype=torch.int32),
                      loc_need=loc_need)
