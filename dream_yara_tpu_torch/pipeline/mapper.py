"""Single-bin mapper orchestration (counterpart of
dream_yara_tpu/pipeline/mapper.py): chunk the batch, dispatch the map step
of every chunk, then drain — fetch, spill fallbacks, host match tables.

Dispatch is asynchronous on a CUDA device: the step's kernels are queued on
the current stream, and each chunk's bundle is copied to pinned host memory
behind them, with an event the drain waits on. So a caller that dispatches
batch i+1 before draining batch i keeps the card busy while the host
finishes batch i. The drain is the only place that synchronises.
"""

from __future__ import annotations

import numpy as np
import torch

from .._shared import (FMIndex, GlobalContigs, Matches, MapperOptions, Ranked,
                       ReadBatch, SeqStore, StageTimers, build_matches,
                       compute_cigars, dedup_matches, rank_matches,
                       sam_header, write_se_records)
from ..ops.device_index import DeviceFM, to_device
from ..ops.readpack import pack_blob_with_lengths
from .map_step import (MapStepOut, max_seed_len_static,
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


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to dream_yara_tpu_torch yet "
        f"(ROADMAP Queue 1 item {item})")


class BinMapper:
    """Maps read batches against ONE bin (local coordinates) on `device`."""

    def __init__(self, store: SeqStore, fm: FMIndex, opts: MapperOptions,
                 device: torch.device, timers: StageTimers | None = None):
        if fm.sample_rate > 1:
            raise _not_ported("sampled-SA mapping", 11)
        self.store = store
        self.fm = fm
        self.opts = opts
        self.device = torch.device(device)
        self.dev = DeviceFM.from_host(fm, store.text, self.device)
        self.prefix_q = fm.prefix_q
        self.timers = timers or StageTimers()

    def map_batch(self, batch: ReadBatch, capacity: int = 8) -> Matches:
        """All matches (bin-local global-text coords)."""
        return self.map_batch_async(batch, capacity)()

    def map_batch_async(self, batch: ReadBatch, capacity: int = 8):
        """Queue the batch's device work now; return a drain() closure that
        waits, fetches and post-processes."""
        if batch.paired:
            raise _not_ported("paired-end mapping", 10)
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
                                                  max_err))
        pending = []
        for c0 in range(0, n, half):
            ids = np.arange(c0, min(c0 + half, n))
            lens_c = np.zeros(half, dtype=np.int32)
            lens_c[: len(ids)] = batch.lengths[ids]
            blob = pack_blob_with_lengths(batch.seqs[ids], lens_c, half, L)
            with self.timers.stage("seed+search+verify (device)"):
                out = single_bin_map_step_packed(
                    self.dev, to_device(blob.view(np.int32), self.device),
                    half=half, L=L, compact_cap=compact_cap, **step_kw)
                fetch = _Fetch(out[0])
            pending.append((out, fetch, ids, lens_c))

        def drain():
            return self._drain_pending(pending, batch, n, half, chunk_rows, L,
                                       max_err, rate_ppm, step_kw)
        return drain

    def _drain_pending(self, pending, batch, n, half, chunk_rows, L,
                       max_err, rate_ppm, step_kw) -> Matches:
        def full_reads(ids):
            reads_c = np.full((chunk_rows, L), 4, dtype=np.int8)
            reads_c[: len(ids)] = batch.seqs[ids]
            reads_c[half : half + len(ids)] = batch.seqs[n + ids]
            return reads_c

        parts: list[Matches] = []
        for (out, fetch, ids, lens_c) in pending:
            _bundle_dev, s_lo, s_hi, ovf, m_st = out
            with self.timers.stage("device wait+fetch"):
                bundle = fetch.result()
            with self.timers.stage("collect matches (host)"):
                out = unbundle_out(bundle, s_lo, s_hi, ovf, m_st,
                                   L, max_err, chunk_rows)
            if int(out.n_spilled) > 0:
                # compaction spilled: redo the chunk verifying every slot,
                # in bounded sub-chunks; these matches replace the compacted
                # set, and the seed arrays of the compacted run stay valid
                with self.timers.stage("dense re-verify (device)"):
                    parts.extend(self._dense_reverify(batch, ids, n, L,
                                                      max_err, step_kw))
            else:
                with self.timers.stage("collect matches (host)"):
                    m = build_matches(out.row, out.begin, out.end, out.dist,
                                      out.ok, n_reads=half)
                    parts.append(self._remap_chunk(m, ids, half, n))

            if int(out.overflow_total) > 0 and self.opts.sensitivity != "low":
                if self.opts.sensitivity != "full":
                    raise _not_ported(
                        "the repetitive re-seed pass (sensitivity "
                        f"{self.opts.sensitivity!r} with overflowing seeds)", 12)
                out = out._replace(seed_lo=out.seed_lo.cpu().numpy(),
                                   seed_hi=out.seed_hi.cpu().numpy(),
                                   overflow=out.overflow.cpu().numpy(),
                                   m_start=out.m_start.cpu().numpy())
                with self.timers.stage("overflow fallback"):
                    parts.append(self._overflow_pass(
                        out, full_reads(ids), lens_c, ids, half, n, max_err,
                        rate_ppm))
        # dedup happens after the cross-contig filter (map_single_bin)
        return Matches.concat(parts)

    DENSE_HALF = 8192  # dense re-verify sub-chunk reads: bounds device memory

    def _dense_reverify(self, batch, ids, n, L, max_err, step_kw):
        """Re-map the chunk's reads with every slot verified (no
        compaction), in fixed-size sub-chunks; seeding, per-row dedup and
        verification are row-local, so the output equals a whole-chunk pass."""
        sub_half = self.DENSE_HALF
        parts = []
        for s0 in range(0, len(ids), sub_half):
            sids = ids[s0 : s0 + sub_half]
            lens_s = np.zeros(sub_half, dtype=np.int32)
            lens_s[: len(sids)] = batch.lengths[sids]
            blob = pack_blob_with_lengths(batch.seqs[sids], lens_s, sub_half, L)
            bundle, s_lo, s_hi, ovf, m_st = single_bin_map_step_packed(
                self.dev, to_device(blob.view(np.int32), self.device),
                half=sub_half, L=L, verify_capacity=None, **step_kw)
            o = unbundle_out(_Fetch(bundle).result(), s_lo, s_hi, ovf, m_st,
                             L, max_err, 2 * sub_half)
            m = build_matches(o.row, o.begin, o.end, o.dist, o.ok,
                              n_reads=sub_half)
            parts.append(self._remap_chunk(m, sids, sub_half, n))
        return parts

    def _remap_chunk(self, m: Matches, ids: np.ndarray, half: int, n: int) -> Matches:
        """Chunk-local read ids/strands -> batch ids."""
        m = m.take(m.read_id < len(ids))
        m.read_id = ids[m.read_id].astype(np.int32)
        return m

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
        for b0 in range(0, len(rows), FALLBACK_PAD):
            rb = rows[b0 : b0 + FALLBACK_PAD]
            ab = anchors[b0 : b0 + FALLBACK_PAD]
            padn = FALLBACK_PAD - len(rb)
            mask = np.concatenate([np.ones(len(rb), bool), np.zeros(padn, bool)])
            rb = np.concatenate([rb, np.zeros(padn, np.int32)])
            ab = np.concatenate([ab, np.zeros(padn, np.int32)])
            dist, beg, end = verify_positions(
                self.dev, reads_d, lens_d, to_device(rb, self.device),
                to_device(ab, self.device), to_device(mask, self.device),
                max_errors=max_err)
            dist, beg, end = (_Fetch(x).result() for x in (dist, beg, end))
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
        raise _not_ported("paired-end mapping", 10)
    ranked, cigars, contigs = map_single_bin(store, fm, batch, opts, device)
    return (("\n".join(sam_header(contigs, cmdline,
                                   read_group=opts.read_group or None))
             + "\n").encode()
            + write_se_records(batch, contigs, ranked, cigars,
                               read_group=opts.read_group or None,
                               secondary_mode=opts.secondary_matches))
