"""The DREAM mesh step on one device: classify -> route -> map (counterpart
of dream_yara_tpu/parallel/dist_mapper.py).

A (data, bin) layout of devices holds read shard d and bin shard j on
device (d, j). This module runs one such device's step as a plain function
on one CUDA (or CPU) device: the layout is (data=1, bin=1) until the
multi-GPU edition (ROADMAP item 16), and the host loops over both axes
anyway, so adding ranks does not reshape the host logic.

  1. classify: the prefilter's candidate bins of every read, bit for bit
     the single-device classifier (ops/ibf_query.py), in row chunks of
     IBF_READS reads to bound memory; or an explicit routing (the drain
     pass); or every read to every bin (filter none);
  2. route: the routed (read, bin) pairs compact into one pool of r_cap
     slots (pipeline/flat_step.slot_pool); pairs past the pool are counted;
  3. map: the pool maps in one flat step over the stacked bins.

Every capacity cut is counted (route_overflow, per-row seed overflow, the
verify spill), and the host driver (parallel/dream_mesh.py) drains or
re-maps what was cut, so the output equals the single-device pipeline's.
Positions stay bin-local int32; the host adds each bin's int64 offset.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.device_index import DeviceFMSet
from ..ops.ibf_query import ibf_candidates, pack_mask_bits
from ..ops.readpack import (int32_bits, pack_blob_with_lengths, unpack_blob,
                            unpack_reads)
from ..pipeline.dis_mapper import IBF_READS
from ..pipeline.flat_step import flat_map_step, slot_pool
from ..pipeline.mapper import _Fetch


class MeshMapOut(NamedTuple):
    """Per-device flat-pool outputs; the leading axis is the bin shard.

    Slot order is the pool's bin-major order, so the host rebuilds
    slot -> (read, bin) from the routing bits alone (decode_flat_device).
    On the device every field is int32 or bool; route_words and meta hold
    uint32 bit patterns (bit 31 live)."""

    begin: object           # (bin_ax, D * cap2v) int32 bin-local begin
    end: object             # (bin_ax, D * cap2v) int32 bin-local end
    meta: object            # (bin_ax, D * cap2v) row | dist << 20 | ok << 31
    overflow_total: object  # (bin_ax, D) int32 seed-hit overflow
    n_spilled: object       # (bin_ax, D) int32 verify-lane spills
    route_overflow: object  # (bin_ax, D) int32 pairs beyond the pool
    route_words: object     # (n_pad, ceil(B/32)) routing bits
    ovf_rows: object        # (bin_ax, D * 2 * t_cap) bool seed overflow per
                            # slot row ([t_cap fwd | t_cap rc])
    v_need: object          # (bin_ax, D) int32 verify-lane demand
    loc_need: object        # (bin_ax, D) int32 locate-lane demand


META_ROW_BITS = 20            # flat slot rows: up to 2 * t_cap < 2^20
META_ROW_MASK = (1 << META_ROW_BITS) - 1
META_DIST_SHIFT = META_ROW_BITS
META_OK_SHIFT = 31


def mesh_local_step(fmset: DeviceFMSet, filter_words, blob, route_in=None, *,
                    half_loc: int, L: int, B: int, r_cap: int, rate_ppm: int,
                    max_errors: int, capacity: int, max_slen: int,
                    prefix_q: int, sample_rate: int, cap2v: int,
                    k: int = 0, n_hashes: int = 0, window: int = 0,
                    use_filter: bool = True, uniform_len: bool = False,
                    canonical: bool = False, blocked: bool = False,
                    direct: bool = False, block_s: int = 0,
                    slack_table=None, cap2l: float | None = None) -> MeshMapOut:
    """One device's step: (fmset, filter words, blob[, route words]) ->
    MeshMapOut. `blob` is the device's pack_blob_with_lengths upload held as
    int32; `route_in` (half_loc, ceil(B/32)) int32 routing bits replace the
    classify (the drain pass). fmset holds all B bins (one bin shard).
    Never synchronises with the host."""
    packed, nmask, lengths = unpack_blob(blob, half_loc, L)
    reads = unpack_reads(packed, nmask, lengths, L)                # (2h, L)
    dev = reads.device
    if route_in is not None:
        shifts = torch.arange(32, device=dev, dtype=torch.int32)
        bits = (route_in[:, :, None] >> shifts) & 1
        cand = bits.reshape(half_loc, -1)[:, :B].bool() & (lengths > 0)[:, None]
    elif use_filter:
        # classify IBF_READS reads a call, as the single-device path does:
        # it bounds the gathered block rows (rows are independent)
        kw = dict(k=k, n_hashes=n_hashes, rate_ppm=rate_ppm, window=window,
                  canonical=canonical, blocked=blocked, direct=direct,
                  n_bins=B, block_s=block_s)
        parts = []
        for c0 in range(0, half_loc, IBF_READS):
            c1 = min(c0 + IBF_READS, half_loc)
            rows = torch.cat([reads[c0:c1], reads[half_loc + c0 : half_loc + c1]])
            parts.append(ibf_candidates(filter_words, rows, lengths[c0:c1],
                                        slack_table, half=c1 - c0, **kw)[:, :B])
        cand = torch.cat(parts)
    else:
        cand = (lengths > 0)[:, None].expand(half_loc, B)
    route_words = pack_mask_bits(cand)
    read_slot, bin_slot, valid, route_ovf = slot_pool(cand, r_cap)
    out = flat_map_step(
        fmset, reads, lengths, read_slot, bin_slot, valid, half_loc=half_loc,
        rate_ppm=rate_ppm, max_errors=max_errors, capacity=capacity,
        max_slen=max_slen, prefix_q=prefix_q, compact_cap=cap2v,
        uniform_len=uniform_len, sample_rate=sample_rate, cap2l=cap2l)
    meta = int32_bits(out.row.long()
                      | (out.dist.clamp(0, 31).long() << META_DIST_SHIFT)
                      | (out.ok.long() << META_OK_SHIFT))
    ovf_row = out.overflow.reshape(2 * r_cap, -1).sum(dim=1) > 0
    one = lambda x: x.to(torch.int32).reshape(1, 1)
    return MeshMapOut(begin=out.begin[None], end=out.end[None],
                      meta=meta[None], overflow_total=one(out.overflow_total),
                      n_spilled=one(out.n_spilled),
                      route_overflow=one(route_ovf), route_words=route_words,
                      ovf_rows=ovf_row[None], v_need=one(out.v_need),
                      loc_need=one(out.loc_need))


def fetch_mesh_out(out: MeshMapOut):
    """Queue the copy of every field to the host behind the step; the
    returned callable waits for them and gives the numpy MeshMapOut
    (route_words and meta as uint32 / int32 bit patterns)."""
    fetches = [_Fetch(x) for x in out]

    def result() -> MeshMapOut:
        host = MeshMapOut(*(f.result() for f in fetches))
        return host._replace(route_words=host.route_words.view(np.uint32))
    return result


def pack_batch_blob(seqs_fwd: np.ndarray, lengths: np.ndarray, data_ax: int,
                    L: int):
    """Per-data-shard packed uploads, concatenated. seqs_fwd: (n, L) forward
    rows. Reads are padded with length-0 rows to data_ax * half_loc; the
    global read id of (shard d, slot s) is d * half_loc + s. Returns
    (blob, half_loc)."""
    n = len(lengths)
    half_loc = (n + data_ax - 1) // data_ax
    blobs = []
    for d in range(data_ax):
        ids = np.arange(d * half_loc, min((d + 1) * half_loc, n))
        lens = np.zeros(half_loc, dtype=np.int32)
        lens[: len(ids)] = lengths[ids]
        blobs.append(pack_blob_with_lengths(seqs_fwd[ids], lens, half_loc, L))
    return np.concatenate(blobs), half_loc


def decode_flat_device(out: MeshMapOut, jrow: int, d: int,
                       routing: np.ndarray, half_loc: int, B_loc: int,
                       t_cap: int, sens: str, bin_col0: int | None = None):
    """Decode one (bin shard j, data shard d) device's host MeshMapOut.

    Slot order is the device's bin-major pool order, rebuilt here from the
    routing bits. Returns (m, fb_pairs, leftover_pairs, spilled):
      m: dict of match arrays (read_id, bin_local, strand, begin, end, dist),
         bin_local in [0, B_loc); None when the device found nothing;
      fb_pairs: (reads, bins_local) whose seed hits overflowed (an
         exhaustive re-map is needed; their pool matches are dropped);
      leftover_pairs: (reads, bins_local) beyond the pool (drain pass);
      spilled: the verify compaction spilled; the caller re-maps all of
         this device's routed pairs (m is then None)."""
    if bin_col0 is None:
        bin_col0 = jrow * B_loc
    n = routing.shape[0]
    r0 = d * half_loc
    rsub = np.zeros((half_loc, B_loc), dtype=bool)
    rows = routing[r0 : min(r0 + half_loc, n)]
    rsub[: rows.shape[0]] = rows[:, bin_col0 : bin_col0 + B_loc]
    src = np.flatnonzero(rsub.T.reshape(-1))          # bin-major slot order
    slots, leftover_src = src[:t_cap], src[t_cap:]
    bin_l = (slots // half_loc).astype(np.int64)
    read_l = (slots % half_loc).astype(np.int64)
    leftover_pairs = (r0 + leftover_src % half_loc, leftover_src // half_loc)
    n_slots = len(slots)

    if int(out.n_spilled[jrow, d]) > 0:
        return None, (np.zeros(0, np.int64), np.zeros(0, np.int64)), \
            leftover_pairs, True

    # ovf_rows strides by seq rows (2 * t_cap a shard), meta/begin/end by
    # verify lanes (cap2v a shard): take cap2v from the array shape
    r2 = 2 * t_cap
    ovf = out.ovf_rows[jrow, d * r2 : (d + 1) * r2]
    slot_ovf = (ovf[:t_cap] | ovf[t_cap:])[:n_slots]
    if sens == "low":
        slot_ovf = np.zeros(n_slots, dtype=bool)
    fb_pairs = (r0 + read_l[slot_ovf], bin_l[slot_ovf])

    n_data = out.ovf_rows.shape[1] // r2
    cap2 = out.meta.shape[1] // n_data
    meta = out.meta[jrow, d * cap2 : (d + 1) * cap2].view(np.uint32)
    ok = (meta >> META_OK_SHIFT) > 0
    if not ok.any():
        return None, fb_pairs, leftover_pairs, False
    meta = meta[ok]
    row = (meta & META_ROW_MASK).astype(np.int64)
    dist = ((meta >> META_DIST_SHIFT) & 31).astype(np.int32)
    slot = row % t_cap
    strand = (row // t_cap).astype(np.int8)
    keep = slot < n_slots
    if slot_ovf.any():
        keep &= ~np.where(keep, slot_ovf[np.minimum(slot, n_slots - 1)], False)
    last = np.minimum(slot, n_slots - 1)
    m = dict(
        read_id=(r0 + read_l[last])[keep],
        bin_local=bin_l[last][keep],
        strand=strand[keep],
        begin=out.begin[jrow, d * cap2 : (d + 1) * cap2][ok][keep].astype(np.int64),
        end=out.end[jrow, d * cap2 : (d + 1) * cap2][ok][keep].astype(np.int64),
        dist=dist[keep])
    return m, fb_pairs, leftover_pairs, False


def pack_route_words(routing: np.ndarray, B: int) -> np.ndarray:
    """(n_pad, B) bool -> (n_pad, ceil(B/32)) uint32 (inverse of
    decode_routing): the routing override of a drain pass."""
    n_pad = routing.shape[0]
    Wb = (B + 31) // 32
    rb = np.zeros((n_pad, Wb * 32), dtype=bool)
    rb[:, :B] = routing[:, :B]
    return (rb.reshape(n_pad, Wb, 32).astype(np.uint32)
            << np.arange(32, dtype=np.uint32)[None, None, :]).sum(
                axis=2, dtype=np.uint32)


def decode_routing(route_words: np.ndarray, n: int, B: int) -> np.ndarray:
    """(n_pad, Wb) uint32 -> (n, B) bool candidate mask."""
    bits = ((route_words[:, :, None]
             >> np.arange(32, dtype=np.uint32)[None, None, :]) & 1)
    return bits.reshape(route_words.shape[0], -1)[:n, :B].astype(bool)
