"""DREAM orchestration: routing + per-bin mapping + global merge
(counterpart of dream_yara_tpu/pipeline/dis_mapper.py).

This slice routes with filter `none` (every read to every bin) and maps
single-end batches. The IBF and k-mer-direct prefilters (ROADMAP Queue 1
item 13) and paired-end batches with mate rescue (item 10) raise
NotImplementedError rather than degrade.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from queue import Queue

import numpy as np
import torch

from .._shared import (FMIndex, GlobalContigs, Matches, MapperOptions, Ranked,
                       ReadBatch, SeqStore, StageTimers, compute_cigars,
                       dedup_matches, rank_matches, sam_header,
                       write_se_records)
from .mapper import BinMapper, _not_ported
from .seeding import max_errors_for_batch

# finisher-pool threads (dream_map_stream) share the caller's stats dict
_STATS_LOCK = threading.Lock()


def bin_file(db_dir, bin_id: int, kind: str) -> Path:
    """Zero-padded per-bin artifact path."""
    return Path(db_dir) / "bins" / f"{bin_id:04d}.{kind}.npz"


class DreamIndex:
    """All per-bin artifacts + the prefilter, with the bins' device indexes
    built on `device` when a bin is first mapped."""

    def __init__(self, stores: list[SeqStore], fms: list[FMIndex], filt,
                 filter_type: str = "bloom", *, device: torch.device):
        self.stores = stores
        self.fms = fms
        self.filter = filt
        self.filter_type = filter_type if filt is not None else "none"
        self.device = torch.device(device)
        self.contigs = GlobalContigs.from_stores(stores)
        self.global_text = np.concatenate([st.text for st in stores])
        self._bin_mappers: dict[int, BinMapper] = {}

    @property
    def n_bins(self) -> int:
        return len(self.stores)

    @classmethod
    def load(cls, db_dir, filter_type: str = "bloom", *,
             device: torch.device) -> "DreamIndex":
        """Per-bin stores and FM indexes of a database directory. As in the
        reference, a missing filter file means filter `none`; a present
        one needs the prefilter, which is not ported. Bidirectional
        sidecars serve only the repetitive pass and are not read."""
        db_dir = Path(db_dir)
        filter_file = {"bloom": "db.filter.npz", "kmer_direct": "db.kdx.npz"}
        if filter_type in filter_file and (db_dir / filter_file[filter_type]).exists():
            raise _not_ported(f"the {filter_type!r} prefilter", 13)
        meta = json.loads((db_dir / "meta.json").read_text())
        stores = [SeqStore.load(bin_file(db_dir, b, "store"))
                  for b in range(meta["n_bins"])]
        fms = [FMIndex.load(bin_file(db_dir, b, "fm"))
               for b in range(meta["n_bins"])]
        return cls(stores, fms, None, "none", device=device)

    def bin_mapper(self, b: int, opts: MapperOptions,
                   timers: StageTimers | None = None) -> BinMapper:
        if b not in self._bin_mappers:
            self._bin_mappers[b] = BinMapper(self.stores[b], self.fms[b], opts,
                                             self.device, timers=timers)
        bm = self._bin_mappers[b]
        if timers is not None:
            bm.timers = timers
        return bm


def classify_reads(index: DreamIndex, batch: ReadBatch, opts: MapperOptions,
                   timers: StageTimers | None = None) -> np.ndarray:
    """Candidate bin mask per read: (n_reads, n_bins) bool."""
    if index.filter_type == "none" or index.filter is None:
        return np.ones((batch.n_reads, index.n_bins), dtype=bool)
    raise _not_ported(f"the {index.filter_type!r} prefilter", 13)


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
    closure producing the merged global Matches."""
    if batch.paired:
        raise _not_ported("paired-end mapping", 10)
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
    if batch.paired:
        raise _not_ported("paired-end mapping", 10)
    max_err = max(1, max_errors_for_batch(batch.max_len, opts.error_rate))

    with timers.stage("rank/dedup (host)"):
        ok = index.contigs.same_contig_span(m.begin, m.end)
        ranked: Ranked = rank_matches(dedup_matches(m.take(ok)), batch.n_reads,
                                      strata_count=opts.strata_count)
    with timers.stage("cigar (host)"):
        rows = (ranked.matches.read_id +
                ranked.matches.strand.astype(np.int32) * batch.n_reads)
        cigars = compute_cigars(index.global_text, batch.seqs, rows,
                                batch.lengths[ranked.matches.read_id],
                                ranked.matches.begin, ranked.matches.end,
                                max_err, dists=ranked.matches.dist)
    with timers.stage("sam write (host)"):
        head = (("\n".join(sam_header(index.contigs, cmdline,
                                       read_group=opts.read_group or None))
                 + "\n").encode() if header else b"")
        body = write_se_records(batch, index.contigs, ranked, cigars,
                                read_group=opts.read_group or None,
                                secondary_mode=opts.secondary_matches)

    if stats is not None:
        with _STATS_LOCK:
            stats["reads"] = stats.get("reads", 0) + batch.n_reads
            stats["mapped"] = stats.get("mapped", 0) + int((ranked.c1 > 0).sum())
            stats["unique"] = stats.get("unique", 0) + int(
                ((ranked.c1 == 1) & (ranked.c2 == 0)).sum())
    return head + body
