"""Single-bin mapper orchestration (counterpart of
dream_yara_tpu/pipeline/mapper.py): chunk the batch, dispatch the map step
of every chunk, then drain — fetch, spill fallbacks, host match tables;
and the single-bin paired-end pipeline (mate rescue, pair selection).

Dispatch is asynchronous on a CUDA device: the step's kernels are queued on
the current stream, and each chunk's bundle is copied to pinned host memory
behind them, with an event the drain waits on. So a caller that dispatches
batch i+1 before draining batch i keeps the card busy while the host
finishes batch i. The drain is the only place that synchronises.

Seeds that overflow their capacity go, at sensitivity `full`, to the host
overflow pass, and at `high` to the repetitive re-seed strata
(`_repetitive_pass`, on the device); `low` keeps the capped hits only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..index.fmindex import FMIndex
from ..io.readstore import ReadBatch
from ..io.seqstore import SeqStore
from ..utils.options import MapperOptions
from ..utils.timer import StageTimers, device_span
from .cigar import compute_cigars
from .matches import Matches, Ranked, build_matches, dedup_matches, rank_matches
from .pairs import rescue_candidates, select_pairs
from .writer import GlobalContigs, sam_header, write_pe_records, write_se_records
from ..ops.approx_search import lockstep_rank_rows
from ..ops.device_index import DeviceFM, to_device
from ..ops.readpack import pack_blob_with_lengths
from .map_step import (MapStepOut, max_rep_seed_len_static,
                       max_seed_len_static, repetitive_map_step,
                       single_bin_map_step_packed, unbundle_out,
                       uniform_len_ok, verify_positions)
from .seeding import max_errors_for_batch, rate_to_ppm

CHUNK_SIZES = (2048, 16384, 131072)  # seq-row chunk shapes; they bound memory
FALLBACK_PAD = 4096                  # lanes per overflow-verify call


class _Fetch:
    """A device tensor's copy to the host, queued behind the work that
    makes it; `result()` waits for that copy alone."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = t.to("cpu", non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host, self._event = t, None

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def verify_padded(dev: DeviceFM, reads_d: torch.Tensor, lens_d: torch.Tensor,
                  rows: np.ndarray, anchors: np.ndarray, max_err: int):
    """Verify explicit (row, anchor) candidates in calls of FALLBACK_PAD
    lanes (the overflow pass and mate rescue). Yields, per call, the
    padded host arrays (rows, mask, dist, begin, end); `mask` marks the
    real lanes."""
    device = reads_d.device
    for b0 in range(0, len(rows), FALLBACK_PAD):
        rb = rows[b0 : b0 + FALLBACK_PAD]
        ab = anchors[b0 : b0 + FALLBACK_PAD]
        padn = FALLBACK_PAD - len(rb)
        mask = np.concatenate([np.ones(len(rb), bool), np.zeros(padn, bool)])
        rb = np.concatenate([rb, np.zeros(padn, np.int32)])
        ab = np.concatenate([ab, np.zeros(padn, np.int32)])
        dist, beg, end = verify_positions(
            dev, reads_d, lens_d, to_device(rb, device), to_device(ab, device),
            to_device(mask, device), max_errors=max_err)
        yield (rb, mask, *(_Fetch(x).result() for x in (dist, beg, end)))


class BinMapper:
    """Maps read batches against ONE bin (local coordinates) on `device`.
    `rfused`: the reverse-text fused rank rows (index/bifm.py), which
    enable the bidirectional seed backend of the repetitive strata.

    `dev`: a DeviceFM already on `device` (a DeviceFMSet.bin view of the
    flat step's stacked set) to use instead of an upload; `prefix_q` and
    `sample_rate` must then describe that layout (the set's common q and
    rate), and `rfused` is not used, as in the reference."""

    def __init__(self, store: SeqStore, fm: FMIndex, opts: MapperOptions,
                 device: torch.device, timers: StageTimers | None = None,
                 rfused: np.ndarray | None = None, dev: DeviceFM | None = None,
                 prefix_q: int | None = None, sample_rate: int | None = None):
        self.store = store
        self.fm = fm
        self.opts = opts
        self.device = torch.device(device)
        self.dev = (DeviceFM.from_host(fm, store.text, self.device, rfused=rfused)
                    if dev is None else dev)
        self.prefix_q = fm.prefix_q if prefix_q is None else prefix_q
        self.sample_rate = fm.sample_rate if sample_rate is None else sample_rate
        self.timers = timers or StageTimers()

    def map_batch(self, batch: ReadBatch, capacity: int = 8) -> Matches:
        """All matches (bin-local global-text coords)."""
        return self.map_batch_async(batch, capacity)()

    def map_batch_async(self, batch: ReadBatch, capacity: int = 8,
                        traced: bool | None = None):
        """Queue the batch's device work now; return a drain() closure that
        waits, fetches and post-processes. The mates of a paired batch map
        as independent reads.

        `traced`: whether this batch is traced (counters, and on a card the
        device spans of its map steps, strata and dense re-verify), decided
        once at dispatch; by default `timers.spans` now."""
        if traced is None:
            traced = getattr(self.timers, "spans", False)
        opts = self.opts
        rate_ppm = rate_to_ppm(opts.error_rate)
        n = batch.n_reads
        L = batch.max_len
        max_err = max(1, max_errors_for_batch(L, opts.error_rate))
        max_slen = max_seed_len_static(L, rate_ppm)

        chunk_rows = CHUNK_SIZES[-1]
        for cs in CHUNK_SIZES:
            if 2 * n <= cs:
                chunk_rows = cs
                break
        half = chunk_rows // 2
        compact_cap = chunk_rows  # global verify budget: ~1 lane per seq row
        prefix_q = self.prefix_q if self.dev.pfx_lo is not None else 0
        step_kw = dict(rate_ppm=rate_ppm, max_errors=max_err,
                       capacity=capacity, max_slen=max_slen, prefix_q=prefix_q,
                       uniform_len=uniform_len_ok(batch.lengths, L, rate_ppm,
                                                  max_err),
                       sample_rate=self.sample_rate)
        pending = []
        for c0 in range(0, n, half):
            ids = np.arange(c0, min(c0 + half, n))
            lens_c = np.zeros(half, dtype=np.int32)
            lens_c[: len(ids)] = batch.lengths[ids]
            blob = pack_blob_with_lengths(batch.seqs[ids], lens_c, half, L)
            with self.timers.stage("map step enqueue (host)"):
                span = device_span(self.timers, "map step", self.device,
                                   traced)
                out = single_bin_map_step_packed(
                    self.dev, to_device(blob.view(np.int32), self.device),
                    half=half, L=L, compact_cap=compact_cap, marks=span.mark,
                    **step_kw)
                span.stop()
                fetch = _Fetch(out[0])
            pending.append((out, fetch, ids, lens_c, span))
        if traced:
            self.timers.add("map chunks", len(pending))

        def drain():
            return self._drain_pending(pending, batch, n, half, chunk_rows, L,
                                       max_err, rate_ppm, step_kw, traced)
        return drain

    def _drain_pending(self, pending, batch, n, half, chunk_rows, L,
                       max_err, rate_ppm, step_kw, traced) -> Matches:
        def full_reads(ids):
            reads_c = np.full((chunk_rows, L), 4, dtype=np.int8)
            reads_c[: len(ids)] = batch.seqs[ids]
            reads_c[half : half + len(ids)] = batch.seqs[n + ids]
            return reads_c

        parts: list[Matches] = []
        for (out, fetch, ids, lens_c, span) in pending:
            _bundle_dev, s_lo, s_hi, ovf, m_st = out
            with self.timers.stage("device wait+fetch"):
                bundle = fetch.result()
            span.settle()
            with self.timers.stage("collect matches (host)"):
                out = unbundle_out(bundle, s_lo, s_hi, ovf, m_st,
                                   L, max_err, chunk_rows)
            if int(out.n_spilled) > 0:
                # compaction spilled: redo the chunk verifying every slot,
                # in bounded sub-chunks; these matches replace the compacted
                # set, and the seed arrays of the compacted run stay valid
                if traced:
                    self.timers.add("spilled chunks", 1)
                with self.timers.stage("dense re-verify (device)"):
                    parts.extend(self._dense_reverify(batch, ids, n, L,
                                                      max_err, step_kw,
                                                      traced))
            else:
                with self.timers.stage("collect matches (host)"):
                    m = build_matches(out.row, out.begin, out.end, out.dist,
                                      out.ok, n_reads=half)
                    parts.append(self._remap_chunk(m, ids, half, n))

            if int(out.overflow_total) > 0 and self.opts.sensitivity != "low":
                # sensitivity low keeps the capacity-capped hits only
                out = out._replace(seed_lo=out.seed_lo.cpu().numpy(),
                                   seed_hi=out.seed_hi.cpu().numpy(),
                                   overflow=out.overflow.cpu().numpy(),
                                   m_start=out.m_start.cpu().numpy())
                reads_c = full_reads(ids)
                if self.opts.sensitivity == "full":
                    # complete: expand every spilled SA interval on the host
                    with self.timers.stage("overflow fallback"):
                        parts.append(self._overflow_pass(
                            out, reads_c, lens_c, ids, half, n, max_err,
                            rate_ppm))
                else:
                    with self.timers.stage("repetitive re-seed (device)"):
                        parts.append(self._repetitive_pass(
                            out, reads_c, lens_c, ids, half, n, max_err,
                            rate_ppm, traced))
        # dedup happens after the cross-contig filter (map_single_bin)
        return Matches.concat(parts)

    DENSE_HALF = 8192  # dense re-verify sub-chunk reads: bounds device memory

    def _dense_reverify(self, batch, ids, n, L, max_err, step_kw, traced):
        """Re-map the chunk's reads with every slot verified (no
        compaction), in fixed-size sub-chunks; seeding, per-row dedup and
        verification are row-local, so the output equals a whole-chunk pass.
        Traced, the sub-chunks' device time adds up under "dense re-verify"."""
        sub_half = self.DENSE_HALF
        parts = []
        for s0 in range(0, len(ids), sub_half):
            sids = ids[s0 : s0 + sub_half]
            lens_s = np.zeros(sub_half, dtype=np.int32)
            lens_s[: len(sids)] = batch.lengths[sids]
            blob = pack_blob_with_lengths(batch.seqs[sids], lens_s, sub_half, L)
            span = device_span(self.timers, "dense re-verify", self.device,
                               traced)
            bundle, s_lo, s_hi, ovf, m_st = single_bin_map_step_packed(
                self.dev, to_device(blob.view(np.int32), self.device),
                half=sub_half, L=L, verify_capacity=None, **step_kw)
            span.stop()
            o = unbundle_out(_Fetch(bundle).result(), s_lo, s_hi, ovf, m_st,
                             L, max_err, 2 * sub_half)
            span.settle()
            m = build_matches(o.row, o.begin, o.end, o.dist, o.ok,
                              n_reads=sub_half)
            parts.append(self._remap_chunk(m, sids, sub_half, n))
        return parts

    def _remap_chunk(self, m: Matches, ids: np.ndarray, half: int, n: int) -> Matches:
        """Chunk-local read ids/strands -> batch ids."""
        m = m.take(m.read_id < len(ids))
        m.read_id = ids[m.read_id].astype(np.int32)
        return m

    REP_PAD = 1024  # rows per repetitive re-seed group
    REP1_T = 32     # stratum-1 window truncation (layout lanes ~ 8 t)
    REP2_T = 16     # stratum-2 truncation: 9 C(t, 2) layouts

    def _seed_backend(self, rows_np, lens_c, rate_ppm, budget, indels,
                      t_max) -> str:
        """The approximate-seed backend of one repetitive stratum: `bidir`
        (search schemes) needs the reverse rows on the device, a
        substitution-only stratum and full seed windows (every row's seed
        length >= t_max); anything else enumerates layouts. DY_SEED_BACKEND
        = enum|bidir|auto overrides opts.seed_backend."""
        mode = os.environ.get("DY_SEED_BACKEND",
                              getattr(self.opts, "seed_backend", "auto"))
        if mode == "enum" or self.dev.rfused is None or indels \
                or len(rows_np) == 0:
            return "enum"
        l = lens_c[rows_np % lens_c.shape[0]].astype(np.int64)
        e = (l * rate_ppm) // 10_000
        ns2 = (e + budget + 1) // (budget + 1)
        slen = np.where(ns2 > 0, l // np.maximum(ns2, 1), 0)
        return "bidir" if (slen >= t_max).all() else "enum"

    def _repetitive_pass(self, out: MapStepOut, reads_c, lens_c, ids, half, n,
                         max_err, rate_ppm, traced) -> Matches:
        """Device re-seed of the rows whose exact seeds overflowed. Stratum
        1: ceil((E+1)/2) long seeds with <= 1 edit (substitutions, and one
        indel with opts.indels). Stratum 2: the rows still without a match
        get ceil((E+1)/3) seeds with <= 2 substitutions. Each group of
        REP_PAD rows is timed under "repetitive stratum k (backend)";
        traced, it is also the device span "repetitive stratum k" (its
        first phase, "repetitive upload", the copy of the group's rows and
        mask; then repetitive_map_step's), and the groups, their slots and
        their real rows are counted; an `enum` group also counts the rank
        rows its seed search fetched and those the plain lockstep fetches
        for the same seeds."""
        ns = max_err + 1
        R2 = reads_c.shape[0]
        rep_rows = np.flatnonzero(
            np.asarray(out.overflow).reshape(R2, ns).sum(axis=1) > 0
        ).astype(np.int32)
        if len(rep_rows) == 0:
            return Matches.concat([])
        msl = max_rep_seed_len_static(reads_c.shape[1], rate_ppm)
        reads_d = to_device(reads_c, self.device)
        lens_d = to_device(lens_c, self.device)

        def run(rows_np, stratum, budget, indels, t_max):
            backend = self._seed_backend(rows_np, lens_c, rate_ppm, budget,
                                         indels, t_max)
            parts, matched = [], np.zeros(0, dtype=np.int64)
            for b0 in range(0, len(rows_np), self.REP_PAD):
                rb = rows_np[b0 : b0 + self.REP_PAD]
                padn = self.REP_PAD - len(rb)
                mask = np.concatenate([np.ones(len(rb), bool),
                                       np.zeros(padn, bool)])
                rb = np.concatenate([rb, np.zeros(padn, np.int32)])
                with self.timers.stage(f"repetitive stratum {stratum} ({backend})"):
                    span = device_span(self.timers,
                                       f"repetitive stratum {stratum}",
                                       self.device, traced)
                    rb_d = to_device(rb, self.device)
                    mask_d = to_device(mask, self.device)
                    rank_rows = (torch.zeros(1, dtype=torch.int64,
                                             device=self.device)
                                 if traced and backend == "enum" else None)
                    if span.mark is not None:
                        span.mark("repetitive upload")
                    res = repetitive_map_step(
                        self.dev, reads_d, lens_d, rb_d, mask_d,
                        rate_ppm=rate_ppm,
                        max_errors=max_err, capacity=4, max_slen_rep=t_max,
                        budget=budget, indels=indels, backend=backend,
                        sample_rate=self.sample_rate, marks=span.mark,
                        rank_rows=rank_rows)
                    span.stop()
                    if rank_rows is not None:   # ready once the fetch is
                        rank_rows = rank_rows.to("cpu", non_blocking=True)
                    row, beg, end, dist, ok = _Fetch(torch.stack(
                        [*res[:4], res[4].to(torch.int32)])).result()
                span.settle()
                if traced:
                    self.timers.add("repetitive groups", 1)
                    self.timers.add("repetitive group slots", self.REP_PAD)
                    self.timers.add("repetitive rows", self.REP_PAD - padn)
                if rank_rows is not None:
                    ns2_max = (max_err + budget + 1) // (budget + 1)
                    self.timers.add("repetitive rank rows", int(rank_rows[0]))
                    self.timers.add("repetitive lockstep rows",
                                    lockstep_rank_rows(self.REP_PAD * ns2_max,
                                                       t_max, budget, indels))
                ok = ok.astype(bool)
                matched = np.union1d(matched, row[ok])
                m = build_matches(row, beg, end, dist, ok, n_reads=half)
                parts.append(self._remap_chunk(m, ids, half, n))
            return parts, matched

        parts, matched = run(rep_rows, 1, budget=1, indels=self.opts.indels,
                             t_max=min(msl, self.REP1_T))
        # stratum 2: rows the 1-edit stratum could not place at all
        rows2 = np.setdiff1d(rep_rows, matched).astype(np.int32)
        if len(rows2):
            parts += run(rows2, 2, budget=2, indels=False,
                         t_max=min(msl, self.REP2_T))[0]
        return Matches.concat(parts)

    def _overflow_pass(self, out: MapStepOut, reads_c, lens_c, ids, half, n,
                       max_err, rate_ppm) -> Matches:
        """Verify seed hits beyond device capacity (host expansion, device verify)."""
        over_seeds = np.flatnonzero(out.overflow > 0)
        rows_l, anchors_l = [], []
        ns = max_err + 1
        sa = self.fm.sa
        cap = out.seed_hi - out.seed_lo - out.overflow  # the device capacity
        for s in over_seeds:
            lo, hi = int(out.seed_lo[s]) + int(cap[s]), int(out.seed_hi[s])
            row = s // ns
            l = int(lens_c[row % half]) if row % half < len(ids) else 0
            if l == 0:
                continue
            start = int(out.m_start[s])  # true start of the matched part
            if self.fm.sample_rate > 1:
                pos = np.array([self.fm.locate(r) for r in range(lo, hi)],
                               dtype=np.int64)
            else:
                pos = sa[lo:hi].astype(np.int64)
            rows_l.append(np.full(len(pos), row, dtype=np.int32))
            anchors_l.append((pos - start).astype(np.int32))
        if not rows_l:
            return Matches.concat([])
        rows = np.concatenate(rows_l)
        anchors = np.concatenate(anchors_l)
        reads_d = to_device(reads_c, self.device)
        lens_d = to_device(lens_c, self.device)
        parts = []
        for rb, mask, dist, beg, end in verify_padded(self.dev, reads_d, lens_d,
                                                      rows, anchors, max_err):
            budget = (lens_c[np.clip(rb, 0, 2 * half - 1) % half] * rate_ppm) // 10_000
            ok = mask & (dist <= budget) & (beg >= 0) & (end <= self.fm.n)
            m = build_matches(rb, beg, end, dist, ok, n_reads=half)
            parts.append(self._remap_chunk(m, ids, half, n))
        return Matches.concat(parts)


def map_single_bin(store: SeqStore, fm: FMIndex, batch: ReadBatch,
                   opts: MapperOptions, device: torch.device
                   ) -> tuple[Ranked, list[str], GlobalContigs]:
    """Full single-bin SE pipeline: matches -> contig filter -> rank -> CIGARs."""
    mapper = BinMapper(store, fm, opts, device)
    m = mapper.map_batch(batch)

    contigs = GlobalContigs.from_stores([store])
    m = dedup_matches(m.take(contigs.same_contig_span(m.begin, m.end)))
    ranked = rank_matches(m, batch.n_reads, strata_count=opts.strata_count)

    max_err = max(1, max_errors_for_batch(batch.max_len, opts.error_rate))
    rows = (ranked.matches.read_id +
            ranked.matches.strand.astype(np.int32) * batch.n_reads)
    cigars = compute_cigars(store.text, batch.seqs, rows,
                            batch.lengths[ranked.matches.read_id],
                            ranked.matches.begin, ranked.matches.end, max_err,
                            dists=ranked.matches.dist)
    return ranked, cigars, contigs


def single_bin_sam(store: SeqStore, fm: FMIndex, batch: ReadBatch,
                   opts: MapperOptions, device: torch.device,
                   cmdline: str = "") -> bytes:
    if batch.paired:
        return paired_bin_sam(store, fm, batch, opts, device, cmdline)
    ranked, cigars, contigs = map_single_bin(store, fm, batch, opts, device)
    return (("\n".join(sam_header(contigs, cmdline,
                                   read_group=opts.read_group or None))
             + "\n").encode()
            + write_se_records(batch, contigs, ranked, cigars,
                               read_group=opts.read_group or None,
                               secondary_mode=opts.secondary_matches))


def rescue_mates(mapper: BinMapper, batch: ReadBatch, ranked: Ranked,
                 opts: MapperOptions, max_err: int, rate_ppm: int) -> Matches:
    """Mate rescue: verify unmapped mates in the insert window around their
    mapped partner. Single-bin path: global and bin-local coordinates are
    the same, so the int64 anchors narrow to int32 directly."""
    cands = rescue_candidates(ranked, batch.n_reads, batch.lengths,
                              opts.library_length, opts.library_deviation,
                              band=max_err)
    if len(cands.rows) == 0:
        return Matches.concat([])
    n = batch.n_reads
    reads_d = to_device(batch.seqs, mapper.device)
    lens_d = to_device(batch.lengths, mapper.device)
    parts = []
    for rb, mask, dist, beg, end in verify_padded(
            mapper.dev, reads_d, lens_d, cands.rows,
            cands.anchors.astype(np.int32), max_err):
        budget = (batch.lengths[rb % n] * rate_ppm) // 10_000
        ok = mask & (dist <= budget) & (beg >= 0) & (end <= mapper.fm.n)
        parts.append(build_matches(rb, beg, end, dist, ok, n_reads=n))
    return Matches.concat(parts)


def map_paired_bin(store: SeqStore, fm: FMIndex, batch: ReadBatch,
                   opts: MapperOptions, device: torch.device):
    """Full single-bin PE pipeline: map both mates, rescue, pair, CIGARs."""
    mapper = BinMapper(store, fm, opts, device)
    m = mapper.map_batch(batch)
    contigs = GlobalContigs.from_stores([store])
    rate_ppm = rate_to_ppm(opts.error_rate)
    max_err = max(1, max_errors_for_batch(batch.max_len, opts.error_rate))

    def finish(mm: Matches) -> Ranked:
        ok = contigs.same_contig_span(mm.begin, mm.end)
        return rank_matches(dedup_matches(mm.take(ok)), batch.n_reads,
                            strata_count=opts.strata_count)

    ranked = finish(m)
    if opts.rescue:
        rescued = rescue_mates(mapper, batch, ranked, opts, max_err, rate_ppm)
        if len(rescued):
            ranked = finish(Matches.concat([m, rescued]))

    pair_info = select_pairs(ranked, batch.n_reads, contigs,
                             opts.library_length, opts.library_deviation)
    rows = (ranked.matches.read_id +
            ranked.matches.strand.astype(np.int32) * batch.n_reads)
    cigars = compute_cigars(store.text, batch.seqs, rows,
                            batch.lengths[ranked.matches.read_id],
                            ranked.matches.begin, ranked.matches.end, max_err,
                            dists=ranked.matches.dist)
    return ranked, cigars, contigs, pair_info


def paired_bin_sam(store: SeqStore, fm: FMIndex, batch: ReadBatch,
                   opts: MapperOptions, device: torch.device,
                   cmdline: str = "") -> bytes:
    ranked, cigars, contigs, pair_info = map_paired_bin(store, fm, batch, opts,
                                                        device)
    return (("\n".join(sam_header(contigs, cmdline,
                                   read_group=opts.read_group or None))
             + "\n").encode()
            + write_pe_records(batch, contigs, ranked, cigars, pair_info,
                               read_group=opts.read_group or None,
                               secondary_mode=opts.secondary_matches))
