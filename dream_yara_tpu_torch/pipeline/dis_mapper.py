"""DREAM orchestration: prefilter routing + per-bin mapping + global merge,
single-end and paired-end (counterpart of
dream_yara_tpu/pipeline/dis_mapper.py).

Routing takes the IBF (`bloom`), the direct k-mer filter (`kmer_direct`)
or none. A DreamIndex uploads its filter once, at the first classify;
the reference re-uploads it for every batch, with the same output.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from queue import Queue

import numpy as np
import torch

from ..index.fmindex import FMIndex
from ..index.ibf import InterleavedBloomFilter
from ..index.kdx import DirectKmerFilter
from ..io.readstore import ReadBatch
from ..io.seqstore import SeqStore
from ..utils.options import MapperOptions
from ..utils.timer import StageTimers
from .cigar import compute_cigars
from .matches import Matches, Ranked, build_matches, dedup_matches, rank_matches
from .pairs import rescue_candidates, select_pairs
from .writer import GlobalContigs, sam_header, write_pe_records, write_se_records
from ..ops.device_index import to_device
from ..ops.ibf_query import host_block_rows, ibf_classify_packed
from ..ops.readpack import pack_blob_with_lengths
from .mapper import BinMapper, _Fetch, verify_padded
from .seeding import max_errors_for_batch, rate_to_ppm

# finisher-pool threads (dream_map_stream) share the caller's stats dict
_STATS_LOCK = threading.Lock()

IBF_READS = 32768  # reads per device classify call


def bin_file(db_dir, bin_id: int, kind: str) -> Path:
    """Zero-padded per-bin artifact path."""
    return Path(db_dir) / "bins" / f"{bin_id:04d}.{kind}.npz"


class DreamIndex:
    """All per-bin artifacts + the prefilter, with the bins' device indexes
    built on `device` when a bin is first mapped and the filter uploaded at
    the first classify."""

    def __init__(self, stores: list[SeqStore], fms: list[FMIndex], filt,
                 filter_type: str = "bloom", *, device: torch.device,
                 rfused: dict[int, np.ndarray] | None = None):
        self.stores = stores
        self.fms = fms
        self.filter = filt
        self.filter_type = filter_type if filt is not None else "none"
        self.device = torch.device(device)
        self.contigs = GlobalContigs.from_stores(stores)
        self.global_text = np.concatenate([st.text for st in stores])
        self._bin_mappers: dict[int, BinMapper] = {}
        self._dev_filter = None
        # per-bin reverse-text rank rows (the indexer's --bidir sidecars)
        self.rfused = rfused or {}
        # the device worker and the finisher threads (mate rescue) both
        # create bin mappers and may both reach the filter
        self._lock = threading.Lock()

    @property
    def n_bins(self) -> int:
        return len(self.stores)

    @classmethod
    def load(cls, db_dir, filter_type: str = "bloom", *,
             device: torch.device) -> "DreamIndex":
        """Per-bin stores, FM indexes and bidirectional sidecars (`.rfm`) of
        a database directory, and the requested prefilter. As in the
        reference, a missing filter file means filter `none`, and a sidecar
        whose row count does not fit its bin's index is stale and ignored."""
        db_dir = Path(db_dir)
        meta = json.loads((db_dir / "meta.json").read_text())
        stores, fms, rfused = [], [], {}
        for b in range(meta["n_bins"]):
            stores.append(SeqStore.load(bin_file(db_dir, b, "store")))
            fms.append(FMIndex.load(bin_file(db_dir, b, "fm")))
            rp = bin_file(db_dir, b, "rfm")
            if rp.exists():
                rf = np.load(rp)["rfused"]
                if rf.shape[0] == fms[-1].bwt_blocks.shape[0] + 1:
                    rfused[b] = rf
                else:
                    print(f"[dream] ignoring stale bidir sidecar {rp}",
                          file=sys.stderr)
        filt = None
        if filter_type == "bloom" and (db_dir / "db.filter.npz").exists():
            filt = InterleavedBloomFilter.load(db_dir / "db.filter")
        elif filter_type == "kmer_direct" and (db_dir / "db.kdx.npz").exists():
            filt = DirectKmerFilter.load(db_dir / "db.kdx")
        return cls(stores, fms, filt, filter_type, device=device,
                   rfused=rfused)

    def bin_mapper(self, b: int, opts: MapperOptions,
                   timers: StageTimers | None = None, dev_factory=None,
                   prefix_q: int | None = None,
                   sample_rate: int | None = None) -> BinMapper:
        """Bin b's mapper, made at first use. `dev_factory` (returning a
        DeviceFM already on the device, e.g. DeviceFMSet.bin(b)) and the
        layout overrides apply only then."""
        with self._lock:
            if b not in self._bin_mappers:
                self._bin_mappers[b] = BinMapper(
                    self.stores[b], self.fms[b], opts, self.device,
                    timers=timers, rfused=self.rfused.get(b),
                    dev=dev_factory() if dev_factory else None,
                    prefix_q=prefix_q, sample_rate=sample_rate)
            bm = self._bin_mappers[b]
        if timers is not None:
            bm.timers = timers
        return bm

    def device_filter(self):
        """The prefilter's words on the device, uploaded once:
        (words, block_s, slack_table). Blocked filters take the
        host_block_rows layout (block_s = S); the others keep only the
        words that hold real bins (block_s = 0)."""
        with self._lock:
            if self._dev_filter is None:
                filt, B = self.filter, self.n_bins
                if getattr(filt, "blocked", 0):
                    w_np, block_s = host_block_rows(filt.words, B)
                else:
                    w_np = np.asarray(filt.words)[:, : max(1, (B + 31) // 32)]
                    block_s = 0
                words = to_device(np.ascontiguousarray(w_np).view(np.int32),
                                  self.device)
                slack = getattr(filt, "slack_table", None)
                if slack is not None:
                    slack = to_device(np.asarray(slack, np.int32), self.device)
                self._dev_filter = (words, block_s, slack)
            return self._dev_filter


def classify_reads(index: DreamIndex, batch: ReadBatch, opts: MapperOptions,
                   timers: StageTimers | None = None) -> np.ndarray:
    """Candidate bin mask per read: (n_reads, n_bins) bool.

    A read routes to a bin when either orientation passes the threshold
    (canonical filters answer both from the forward row); filter none
    routes every read to every bin. Each call classifies IBF_READS reads
    on the device and fetches their packed mask: the one host sync of
    routing, before any map step of the batch is queued."""
    n, B = batch.n_reads, index.n_bins
    if index.filter_type == "none" or index.filter is None:
        return np.ones((n, B), dtype=bool)
    filt = index.filter
    words, block_s, slack = index.device_filter()
    L = batch.max_len
    kw = dict(L=L, k=filt.k, n_hashes=filt.n_hashes,
              rate_ppm=rate_to_ppm(opts.error_rate),
              window=getattr(filt, "window", 0),
              canonical=bool(getattr(filt, "canonical", 0)),
              blocked=bool(getattr(filt, "blocked", 0)),
              direct=bool(getattr(filt, "direct", 0)), n_bins=B,
              block_s=block_s)
    mask = np.zeros((n, B), dtype=bool)
    shifts = np.arange(32, dtype=np.uint32)
    for c0 in range(0, n, IBF_READS):
        # chunks are not padded to IBF_READS: rows are classified
        # independently, so the mask is the same
        ids = np.arange(c0, min(c0 + IBF_READS, n))
        blob = pack_blob_with_lengths(batch.seqs[ids], batch.lengths[ids],
                                      len(ids), L)
        cw = ibf_classify_packed(words, to_device(blob.view(np.int32),
                                                  index.device),
                                 slack, half=len(ids), **kw)
        cw = _Fetch(cw).result().view(np.uint32)
        bits = ((cw[:, :, None] >> shifts) & 1).astype(bool)
        mask[ids] = bits.reshape(len(ids), -1)[:, :B]
    return mask


def _sub_batch(batch: ReadBatch, ids: np.ndarray) -> ReadBatch:
    n = batch.n_reads
    return ReadBatch(
        names=[batch.names[i] for i in ids],
        seqs=batch.seqs[np.concatenate([ids, n + ids])],
        lengths=batch.lengths[ids],
        quals=[batch.quals[i] for i in ids],
        paired=False,
    )


def dis_map_batch(index: DreamIndex, batch: ReadBatch, opts: MapperOptions,
                  timers: StageTimers | None = None) -> Matches:
    """Matches in GLOBAL coordinates across all candidate bins."""
    return dis_map_batch_async(index, batch, opts, timers)()


def dis_map_batch_async(index: DreamIndex, batch: ReadBatch,
                        opts: MapperOptions,
                        timers: StageTimers | None = None):
    """Queue all per-bin device work for the batch; return a drain()
    closure producing the merged global Matches. A paired batch maps its
    mates as independent reads; pairing happens when it is finished."""
    timers = timers or StageTimers()
    with timers.stage("ibf classify"):
        routing = classify_reads(index, batch, opts, timers)
    drains = []
    for b in range(index.n_bins):
        ids = np.flatnonzero(routing[:, b])
        if len(ids) == 0:
            continue
        with timers.stage("per-bin subset prep (host)"):
            sub = _sub_batch(batch, ids)
            bm = index.bin_mapper(b, opts, timers)
        drains.append((b, ids, bm.map_batch_async(sub)))

    def drain() -> Matches:
        parts: list[Matches] = []
        for b, ids, d in drains:
            m = d()
            off = int(index.contigs.bin_starts[b])  # bin-local -> global
            m.begin += off
            m.end += off
            m.read_id = ids[m.read_id].astype(np.int32)
            parts.append(m)
        return Matches.concat(parts)

    return drain


def _rescue_global(index: DreamIndex, batch: ReadBatch, ranked: Ranked,
                   opts: MapperOptions, max_err: int, rate_ppm: int) -> Matches:
    """Mate rescue with bin-aware anchors: each candidate's window is
    verified in the bin its int64 global anchor falls in, after the bin
    start is subtracted (then it fits int32). The batch's reads go to the
    device once for all bins."""
    cands = rescue_candidates(ranked, batch.n_reads, batch.lengths,
                              opts.library_length, opts.library_deviation,
                              band=max_err)
    if len(cands.rows) == 0:
        return Matches.concat([])
    bin_of = np.searchsorted(index.contigs.bin_starts, cands.anchors,
                             side="right") - 1
    bin_of = np.clip(bin_of, 0, index.n_bins - 1)
    parts = []
    n = batch.n_reads
    reads_d = to_device(batch.seqs, index.device)
    lens_d = to_device(batch.lengths, index.device)
    for b in np.unique(bin_of):
        sel = bin_of == b
        rows = cands.rows[sel]
        anchors = (cands.anchors[sel]
                   - int(index.contigs.bin_starts[b])).astype(np.int32)
        bm = index.bin_mapper(int(b), opts)
        for rb, mask, dist, beg, end in verify_padded(bm.dev, reads_d, lens_d,
                                                      rows, anchors, max_err):
            budget = (batch.lengths[rb % n] * rate_ppm) // 10_000
            ok = mask & (dist <= budget) & (beg >= 0) & (end <= bm.fm.n)
            mm = build_matches(rb, beg, end, dist, ok, n_reads=n)
            off = int(index.contigs.bin_starts[b])
            mm.begin += off
            mm.end += off
            parts.append(mm)
    return Matches.concat(parts)


def dream_map_stream(index: DreamIndex, batches, opts: MapperOptions,
                     cmdline: str = "", timers: StageTimers | None = None,
                     stats: dict | None = None, header: bool = True):
    """Yield SAM bytes per batch. A device worker thread queues batch i+1's
    device work before draining batch i, and host finishing (rank/dedup,
    CIGARs, SAM) runs on an ordered pool of DY_FINISH_WORKERS threads
    (default 2). Output order and bytes equal the one-batch-at-a-time path."""
    timers = timers or StageTimers()
    n_fin = max(1, int(os.environ.get("DY_FINISH_WORKERS", "2")))
    q: Queue = Queue(maxsize=n_fin)
    sentinel = object()
    err: list[BaseException] = []

    def device_worker():
        prev = None
        try:
            for batch in batches:
                cur = (batch, dis_map_batch_async(index, batch, opts, timers))
                if prev is not None:
                    p, prev = prev, None
                    q.put((p[0], p[1]()))
                prev = cur
        except BaseException as e:  # handed to the consumer, re-raised there
            err.append(e)
        finally:
            if prev is not None:
                # a reader/dispatch error must not drop the in-flight batch
                try:
                    q.put((prev[0], prev[1]()))
                except BaseException as e:
                    if not err:
                        err.append(e)
            q.put(sentinel)

    t = threading.Thread(target=device_worker, daemon=True)
    t.start()
    first = header
    if n_fin == 1:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            batch, m = item
            yield _finish_batch(index, batch, m, opts, cmdline, timers,
                                header=first, stats=stats)
            first = False
    ex = ThreadPoolExecutor(max_workers=n_fin)
    pending: deque = deque()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            batch, m = item
            pending.append(ex.submit(_finish_batch, index, batch, m, opts,
                                     cmdline, timers, first, stats))
            first = False
            while len(pending) >= n_fin:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
        if err:
            raise err[0]
    finally:
        ex.shutdown(wait=True)


def dream_map_sam(index: DreamIndex, batch: ReadBatch, opts: MapperOptions,
                  cmdline: str = "", timers: StageTimers | None = None,
                  header: bool = True, stats: dict | None = None) -> bytes:
    """Full DREAM pipeline for one batch -> SAM bytes."""
    timers = timers or StageTimers()
    m = dis_map_batch(index, batch, opts, timers)
    return _finish_batch(index, batch, m, opts, cmdline, timers, header, stats)


def _finish_batch(index: DreamIndex, batch: ReadBatch, m: Matches,
                  opts: MapperOptions, cmdline: str, timers: StageTimers,
                  header: bool, stats: dict | None) -> bytes:
    rate_ppm = rate_to_ppm(opts.error_rate)
    max_err = max(1, max_errors_for_batch(batch.max_len, opts.error_rate))

    def finish(mm: Matches) -> Ranked:
        ok = index.contigs.same_contig_span(mm.begin, mm.end)
        return rank_matches(dedup_matches(mm.take(ok)), batch.n_reads,
                            strata_count=opts.strata_count)

    with timers.stage("rank/dedup (host)"):
        ranked = finish(m)
    if batch.paired and opts.rescue:
        with timers.stage("mate rescue"):
            rescued = _rescue_global(index, batch, ranked, opts, max_err,
                                     rate_ppm)
            if len(rescued):
                ranked = finish(Matches.concat([m, rescued]))
    with timers.stage("cigar (host)"):
        rows = (ranked.matches.read_id +
                ranked.matches.strand.astype(np.int32) * batch.n_reads)
        cigars = compute_cigars(index.global_text, batch.seqs, rows,
                                batch.lengths[ranked.matches.read_id],
                                ranked.matches.begin, ranked.matches.end,
                                max_err, dists=ranked.matches.dist)
    pair_info = None
    if batch.paired:
        with timers.stage("select pairs (host)"):
            pair_info = select_pairs(ranked, batch.n_reads, index.contigs,
                                     opts.library_length,
                                     opts.library_deviation)
    with timers.stage("sam write (host)"):
        head = (("\n".join(sam_header(index.contigs, cmdline,
                                       read_group=opts.read_group or None))
                 + "\n").encode() if header else b"")
        if batch.paired:
            body = write_pe_records(batch, index.contigs, ranked, cigars,
                                    pair_info,
                                    read_group=opts.read_group or None,
                                    secondary_mode=opts.secondary_matches)
        else:
            body = write_se_records(batch, index.contigs, ranked, cigars,
                                    read_group=opts.read_group or None,
                                    secondary_mode=opts.secondary_matches)

    if stats is not None:
        with _STATS_LOCK:
            stats["reads"] = stats.get("reads", 0) + batch.n_reads
            stats["mapped"] = stats.get("mapped", 0) + int((ranked.c1 > 0).sum())
            stats["unique"] = stats.get("unique", 0) + int(
                ((ranked.c1 == 1) & (ranked.c2 == 0)).sum())
            if pair_info is not None:
                stats["proper_pairs"] = stats.get("proper_pairs", 0) + int(
                    pair_info.proper.sum()) // 2
    return head + body
