"""Multi-process DREAM runtime over torch.distributed (counterpart of
dream_yara_tpu/parallel/multihost.py): per-rank bin-shard loading, the mesh
step on each rank's devices, and the cross-rank merge.

  * the bin axis of the (data, bin) mesh spans the ranks, so each rank
    loads only its own bins' index artifacts (SeqStore.load_meta gives
    everyone the light global contig table); the data axis is the rank's
    local devices;
  * each rank runs classify -> route -> map (parallel/dist_mapper.py) for
    its bin shard as plain function calls on its own devices: nothing but
    the table shapes must agree across ranks;
  * matches, fallback results and per-bin CIGAR strings merge across ranks
    by all-gather, concatenated by rank so the order is deterministic;
    ranking, pairing and MAPQ then run replicated on the global match
    table, and rank 0 writes the SAM.

Everything that crosses ranks is a host numpy array (matches, CIGAR bytes,
three integers), so one gloo process group carries it on CPU and GPU hosts
alike; no device tensor is ever sent. Like the reference, this mapper has
no cap tuner and no drain passes: seed overflow and pool leftovers both go
to the rank's exact single-bin path.
"""

from __future__ import annotations

import datetime
import json
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..index.fmindex import FMIndex
from ..index.ibf import InterleavedBloomFilter
from ..index.kdx import DirectKmerFilter
from ..io.readstore import ReadBatch
from ..io.seqstore import SeqStore
from ..ops.device_index import DeviceFMSet, to_device
from ..pipeline.cigar import compute_cigars
from ..pipeline.dis_mapper import _sub_batch, bin_file, upload_filter
from ..pipeline.map_step import max_seed_len_static
from ..pipeline.mapper import BinMapper, verify_padded
from ..pipeline.matches import (Matches, build_matches, dedup_matches,
                                rank_matches)
from ..pipeline.pairs import rescue_candidates, select_pairs
from ..pipeline.seeding import max_errors_for_batch, rate_to_ppm
from ..pipeline.writer import (GlobalContigs, sam_header, write_pe_records,
                               write_se_records)
from ..utils.options import MapperOptions
from ..utils.timer import StageTimers
from .dist_mapper import (META_ROW_BITS, decode_flat_device, decode_routing,
                          fetch_mesh_outs, mesh_local_step, pack_batch_blob,
                          place_filter, shard_db)
from .mesh import canonical


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   timeout_s: float = 600.0) -> None:
    """Join the process group at tcp://`coordinator` (host:port of rank 0);
    a no-op when a group is already up. The backend is gloo on every host."""
    if dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def make_multihost_mesh(local_devices) -> np.ndarray:
    """The (data, bin) mesh as this rank sees it: the bin axis spans the
    ranks, so a bin shard lies on one rank and that rank alone loads its
    artifacts; the data axis is the rank's `local_devices` (a list, which
    may repeat a device). The other ranks' columns hold None."""
    pid, procs = _world()
    devs = [canonical(d) for d in local_devices]
    mesh = np.full((len(devs), procs), None, dtype=object)
    mesh[:, pid] = devs
    return mesh


def _allgather(arr: np.ndarray) -> np.ndarray:
    """(world, *arr.shape): every rank's equal-shaped array, by rank."""
    _, procs = _world()
    if procs == 1:
        return arr[None]
    mine = torch.from_numpy(np.ascontiguousarray(arr))
    got = [torch.empty_like(mine) for _ in range(procs)]
    dist.all_gather(got, mine)
    return np.stack([g.numpy() for g in got])


def _allgather_concat(arr: np.ndarray) -> np.ndarray:
    """Concatenate per-rank variable-length 1-D arrays over all ranks, in
    rank order: the lengths first, then the arrays padded to the longest."""
    lens = _allgather(np.array([len(arr)], dtype=np.int64)).reshape(-1)
    m = int(lens.max()) if len(lens) else 0
    if m == 0:
        return arr[:0]
    pad = np.zeros(m, dtype=arr.dtype)
    pad[: len(arr)] = arr
    gathered = _allgather(pad)                               # (procs, m)
    return np.concatenate([gathered[p, : lens[p]] for p in range(len(lens))])


def allgather_matches(m: Matches) -> Matches:
    return Matches(
        read_id=_allgather_concat(m.read_id),
        strand=_allgather_concat(m.strand),
        begin=_allgather_concat(m.begin),
        end=_allgather_concat(m.end),
        dist=_allgather_concat(m.dist),
    )


class MultiHostDreamMapper:
    """DREAM mapping across ranks; each rank owns a contiguous bin range and
    maps on `local_devices` (a list, which may repeat a device; `device`
    alone by default). Fallbacks and mate rescue run on `device`."""

    POOL_MAX = 1 << (META_ROW_BITS - 1)   # slot rows must fit the meta row field

    def __init__(self, db_dir, opts: MapperOptions, filter_type: str = "bloom",
                 r_cap: int | None = None, *, device: torch.device,
                 local_devices=None):
        self.opts = opts
        self.device = canonical(device)
        db_dir = Path(db_dir)
        meta = json.loads((db_dir / "meta.json").read_text())
        self.n_bins = meta["n_bins"]
        self.mesh = make_multihost_mesh(local_devices or [self.device])
        self.data_ax, self.bin_ax = self.mesh.shape
        self.mesh_shape = {"data": self.data_ax, "bin": self.bin_ax}
        self.pid, _ = _world()
        self.B = ((self.n_bins + self.bin_ax - 1) // self.bin_ax) * self.bin_ax
        self.B_loc = self.B // self.bin_ax
        self.r_cap_arg = r_cap

        # light global contig table from metadata only (every rank)
        names, lengths, starts, bin_starts = [], [], [], [0]
        pos = 0
        for b in range(self.n_bins):
            nm, offs, lens, tlen = SeqStore.load_meta(bin_file(db_dir, b, "store"))
            names.extend(nm)
            lengths.extend(np.asarray(lens).tolist())
            starts.extend((np.asarray(offs) + pos).tolist())
            pos += tlen
            bin_starts.append(pos)
        while len(bin_starts) <= self.B:
            bin_starts.append(pos)
        self.contigs = GlobalContigs(
            names=names, lengths=np.array(lengths, dtype=np.int64),
            starts=np.array(starts, dtype=np.int64),
            bin_starts=np.array(bin_starts, dtype=np.int64))

        # heavy artifacts: only this rank's bins
        self.my_bins = list(range(self.pid * self.B_loc,
                                  min((self.pid + 1) * self.B_loc, self.n_bins)))
        self.stores = {b: SeqStore.load(bin_file(db_dir, b, "store"))
                       for b in self.my_bins}
        self.fms = {b: FMIndex.load(bin_file(db_dir, b, "fm"))
                    for b in self.my_bins}
        # bidirectional sidecars, as DreamIndex.load takes them
        self.rfused = {}
        for b in self.my_bins:
            rp = bin_file(db_dir, b, "rfm")
            if rp.exists():
                rf = np.load(rp)["rfused"]
                if rf.shape[0] == self.fms[b].bwt_blocks.shape[0] + 1:
                    self.rfused[b] = rf   # stale sidecars are ignored
        # pad sizes, the prefix-table depth and one SA sample rate agreed
        # over all ranks (shapes must match). A rank whose padded bin range
        # is empty sends -1 sentinels, which the agreement ignores
        local_max = max((fm.n for fm in self.fms.values()), default=0)
        local_q = min((fm.prefix_q for fm in self.fms.values()), default=-1)
        local_rates = {fm.sample_rate for fm in self.fms.values()}
        assert len(local_rates) <= 1, "bins must share one SA sample rate"
        maxes = _allgather(np.array(
            [local_max, local_q, local_rates.pop() if local_rates else -1],
            dtype=np.int64))
        max_n = int(maxes[:, 0].max())
        qs = maxes[maxes[:, 1] >= 0, 1]
        self.prefix_q = int(qs.min()) if len(qs) and (qs > 0).all() else 0
        rates = set(maxes[maxes[:, 2] >= 0, 2].tolist()) or {1}
        assert len(rates) == 1, \
            f"every rank must load bins of one sample rate, got {rates}"
        self.sample_rate = int(rates.pop())

        fms_l = [self.fms[b] for b in self.my_bins]
        texts_l = [self.stores[b].text for b in self.my_bins]
        if self.prefix_q:
            for fm, t in zip(fms_l, texts_l):
                if fm.prefix_q != self.prefix_q:
                    fm.build_prefix_table(t, self.prefix_q)
        arrs = DeviceFMSet.build_np(fms_l, texts_l, pad_bins_to=self.B_loc,
                                    max_n=max_n, prefix_q=self.prefix_q,
                                    sample_rate=self.sample_rate)
        if not self.prefix_q:
            arrs["pfx_lo"] = arrs["pfx_hi"] = None
        # this rank's column of the mesh: its bin shard on each local device
        self.fmsets = shard_db(self.mesh[:, self.pid : self.pid + 1], arrs)[:, 0]

        # prefilter: every rank loads the same file
        self.filter = None
        self.filter_type = "none"
        if filter_type == "bloom" and (db_dir / "db.filter.npz").exists():
            self.filter = InterleavedBloomFilter.load(db_dir / "db.filter")
            self.filter_type = "bloom"
        elif filter_type == "kmer_direct" and (db_dir / "db.kdx.npz").exists():
            self.filter = DirectKmerFilter.load(db_dir / "db.kdx")
            self.filter_type = "kmer_direct"
        # per distinct device: (words, slack)
        self.filters, self.filter_kw = place_filter(
            self.filter, self.mesh[:, self.pid],
            lambda dev: upload_filter(self.filter, self.B, dev))
        self._bin_mappers: dict = {}

    # --- the step -----------------------------------------------------------

    def _r_cap(self, half_loc: int) -> int:
        """Shared slot-pool capacity of a device (the reference's multi-host
        rule: twice the read shard over the bin axis, no tuning)."""
        if self.r_cap_arg is not None:
            return min(self.r_cap_arg, self.POOL_MAX)
        if self.filter is None:
            return min(half_loc * self.B_loc, self.POOL_MAX)
        return min(self.POOL_MAX,
                   max(256, min(2 * half_loc,
                                (2 * half_loc + self.bin_ax - 1) // self.bin_ax)))

    def _bin_mapper(self, b: int) -> BinMapper:
        if b not in self._bin_mappers:
            self._bin_mappers[b] = BinMapper(self.stores[b], self.fms[b],
                                             self.opts, self.device,
                                             rfused=self.rfused.get(b))
        return self._bin_mappers[b]

    # --- mapping ------------------------------------------------------------

    def map_batch(self, batch: ReadBatch,
                  timers: StageTimers | None = None) -> Matches:
        """Global int64-coordinate matches, identical on every rank."""
        timers = timers or StageTimers()
        opts = self.opts
        n = batch.n_reads
        L = batch.max_len
        rate_ppm = rate_to_ppm(opts.error_rate)
        max_err = max(1, max_errors_for_batch(L, opts.error_rate))

        blob, half_loc = pack_batch_blob(batch.seqs[:n], batch.lengths,
                                         self.data_ax, L)
        r_cap = self._r_cap(half_loc)
        cap2v = max(8, int(float(os.environ.get("DY_CAP2V", "1.25")) * r_cap))
        blob32 = blob.view(np.int32)
        per = blob32.shape[0] // self.data_ax
        with timers.stage("mesh map enqueue (host)"):
            outs = []
            for d in range(self.data_ax):
                dev = self.mesh[d, self.pid]
                fw, slack = self.filters.get(dev, (None, None))
                outs.append([mesh_local_step(
                    self.fmsets[d], fw, to_device(blob32[d * per : (d + 1) * per], dev),
                    half_loc=half_loc, L=L, B=self.B, r_cap=r_cap,
                    rate_ppm=rate_ppm, max_errors=max_err, capacity=8,
                    max_slen=max_seed_len_static(L, rate_ppm),
                    prefix_q=self.prefix_q, sample_rate=self.sample_rate,
                    cap2v=cap2v, slack_table=slack,
                    bin_col0=self.pid * self.B_loc, **self.filter_kw)])
            # this rank's one bin-shard row of the flat-pool output, and the
            # routing bits of all bins: no raw match buffer crosses ranks
            out = fetch_mesh_outs(outs)()

        routing = decode_routing(out.route_words, n, self.B)
        local_parts: list[Matches] = []
        bin_starts = self.contigs.bin_starts
        # decode each data shard and re-map spill / seed-overflow /
        # pool-overflow pairs on this rank's bins' exact path (the other
        # ranks contribute nothing for them)
        fb_by_bin: dict[int, list] = {}
        for d in range(self.data_ax):
            with timers.stage("mesh collect (host)"):
                m, fb, lo_pairs, spilled = decode_flat_device(
                    out, 0, d, routing, half_loc, self.B_loc, r_cap,
                    opts.sensitivity, bin_col0=self.pid * self.B_loc)
            if spilled:
                with timers.stage("mesh spill fallback (host)"):
                    for b in self.my_bins:
                        sub = routing[d * half_loc : min((d + 1) * half_loc, n), b]
                        ids = np.flatnonzero(sub) + d * half_loc
                        if len(ids):
                            self._host_fallback(batch, b, ids,
                                                int(bin_starts[b]), local_parts)
                continue
            for reads_p, bins_p in (fb, lo_pairs):
                for b_loc in np.unique(bins_p):
                    b = self.pid * self.B_loc + int(b_loc)
                    fb_by_bin.setdefault(b, []).append(reads_p[bins_p == b_loc])
            if m is not None:
                bin_g = self.pid * self.B_loc + m["bin_local"]
                off = bin_starts[np.minimum(bin_g, len(bin_starts) - 1)]
                local_parts.append(Matches(
                    read_id=m["read_id"].astype(np.int32), strand=m["strand"],
                    begin=m["begin"] + off, end=m["end"] + off, dist=m["dist"]))
        for b, idss in sorted(fb_by_bin.items()):
            if b >= self.n_bins:
                continue
            ids = np.unique(np.concatenate(idss))
            with timers.stage("mesh overflow fallback (host)"):
                self._host_fallback(batch, b, ids, int(bin_starts[b]),
                                    local_parts)
        with timers.stage("cross-host merge"):
            return allgather_matches(Matches.concat(local_parts))

    def _host_fallback(self, batch: ReadBatch, b: int, ids: np.ndarray,
                       off: int, parts: list[Matches]) -> None:
        """Re-map a read subset of bin b through the exact single-bin path."""
        m = self._bin_mapper(b).map_batch(_sub_batch(batch, ids))
        m.begin += off
        m.end += off
        m.read_id = ids[m.read_id].astype(np.int32)
        parts.append(m)

    # --- finishing (replicated ranking, owner-computed CIGARs) --------------

    def map_sam(self, batch: ReadBatch, cmdline: str = "",
                timers: StageTimers | None = None, header: bool = True,
                stats: dict | None = None) -> bytes | None:
        """The whole pipeline; SAM bytes on rank 0, None elsewhere."""
        timers = timers or StageTimers()
        opts = self.opts
        m = self.map_batch(batch, timers)
        rate_ppm = rate_to_ppm(opts.error_rate)
        max_err = max(1, max_errors_for_batch(batch.max_len, opts.error_rate))

        def finish(mm: Matches):
            ok = self.contigs.same_contig_span(mm.begin, mm.end)
            return rank_matches(dedup_matches(mm.take(ok)), batch.n_reads,
                                strata_count=opts.strata_count)

        with timers.stage("rank/dedup (host)"):
            ranked = finish(m)
        if batch.paired and opts.rescue:
            with timers.stage("mate rescue (multi-host)"):
                rescued = self._rescue_multihost(batch, ranked, max_err, rate_ppm)
                if len(rescued):
                    ranked = finish(Matches.concat([m, rescued]))

        with timers.stage("cigar (owner hosts)"):
            cigars = self._cigars_multihost(batch, ranked, max_err)

        pair_info = None
        rg = opts.read_group or None
        with timers.stage("sam write (host 0)"):
            if batch.paired:
                pair_info = select_pairs(ranked, batch.n_reads, self.contigs,
                                         opts.library_length,
                                         opts.library_deviation)
            if self.pid != 0:
                return None
            head = (("\n".join(sam_header(self.contigs, cmdline, read_group=rg))
                     + "\n").encode() if header else b"")
            if batch.paired:
                body = write_pe_records(batch, self.contigs, ranked, cigars,
                                        pair_info, read_group=rg,
                                        secondary_mode=opts.secondary_matches)
            else:
                body = write_se_records(batch, self.contigs, ranked, cigars,
                                        read_group=rg,
                                        secondary_mode=opts.secondary_matches)
        if stats is not None:
            stats["reads"] = stats.get("reads", 0) + batch.n_reads
            stats["mapped"] = stats.get("mapped", 0) + int((ranked.c1 > 0).sum())
        return head + body

    def _bin_of(self, gpos: np.ndarray) -> np.ndarray:
        b = np.searchsorted(self.contigs.bin_starts, gpos, side="right") - 1
        return np.clip(b, 0, self.B - 1)

    def _rescue_multihost(self, batch, ranked, max_err, rate_ppm) -> Matches:
        """Each rank verifies the rescue anchors that land in its bins; the
        results merge by all-gather (every rank has the same candidates, so
        the merged result is deterministic)."""
        opts = self.opts
        cands = rescue_candidates(ranked, batch.n_reads, batch.lengths,
                                  opts.library_length, opts.library_deviation,
                                  band=max_err)
        parts: list[Matches] = []
        if len(cands.rows):
            bin_of = self._bin_of(cands.anchors)
            n = batch.n_reads
            reads_d = to_device(batch.seqs, self.device)
            lens_d = to_device(batch.lengths, self.device)
            for b in np.unique(bin_of):
                if int(b) not in self.stores:
                    continue
                sel = bin_of == b
                off = int(self.contigs.bin_starts[b])
                anchors = (cands.anchors[sel] - off).astype(np.int32)
                bm = self._bin_mapper(int(b))
                for rb, mask, dist_, beg, end in verify_padded(
                        bm.dev, reads_d, lens_d, cands.rows[sel], anchors, max_err):
                    budget = (batch.lengths[rb % n] * rate_ppm) // 10_000
                    okm = mask & (dist_ <= budget) & (beg >= 0) & (end <= bm.fm.n)
                    mm = build_matches(rb, beg, end, dist_, okm, n_reads=n)
                    mm.begin += off
                    mm.end += off
                    parts.append(mm)
        return allgather_matches(Matches.concat(parts))

    def _cigars_multihost(self, batch, ranked, max_err) -> list[str]:
        """CIGARs need the bin text: each bin's owner computes them, and
        they merge by all-gathers of (match row, length, packed bytes)."""
        mm = ranked.matches
        bin_of = self._bin_of(mm.begin)
        idx_l, cig_l = [], []
        for b in self.my_bins:
            sel = np.flatnonzero(bin_of == b)
            if len(sel) == 0:
                continue
            off = int(self.contigs.bin_starts[b])
            rows = mm.read_id[sel] + mm.strand[sel].astype(np.int32) * batch.n_reads
            cig_l.extend(compute_cigars(
                self.stores[b].text, batch.seqs, rows,
                batch.lengths[mm.read_id[sel]], mm.begin[sel] - off,
                mm.end[sel] - off, max_err, dists=mm.dist[sel]))
            idx_l.append(sel.astype(np.int64))
        idx = np.concatenate(idx_l) if idx_l else np.zeros(0, dtype=np.int64)
        lens = np.array([len(c) for c in cig_l], dtype=np.int64)
        blob = np.frombuffer("".join(cig_l).encode(), dtype=np.uint8)
        g_idx = _allgather_concat(idx)
        g_lens = _allgather_concat(lens)
        g_blob = _allgather_concat(blob)
        cigars = [""] * len(mm)
        pos = 0
        for i, l in zip(g_idx, g_lens):
            cigars[int(i)] = g_blob[pos : pos + int(l)].tobytes().decode()
            pos += int(l)
        return cigars
