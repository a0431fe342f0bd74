"""The mesh DREAM mapper (counterpart of dream_yara_tpu/parallel/dream_mesh.py):
upload the packed read shards, run classify -> route -> flat map
(parallel/dist_mapper.py) on every device of the (data, bin) mesh
(parallel/mesh.py), decode the match buffers, drain pool overflow through
override passes, and re-map whatever a fixed capacity cut (verify spill,
seed overflow, the drain budget) through the exact single-bin BinMapper on
a view of the resident stacked set. The merged match set, and so the SAM
bytes, equal the single-device DREAM pipeline's for any mesh shape.

One process drives all devices: the steps of a pass are queued on every
device before any result is waited for, so distinct cards work side by
side; shards that share a device run one after another.
"""

from __future__ import annotations

import functools
import os
import threading
from queue import Queue

import numpy as np

from ..io.readstore import ReadBatch
from ..pipeline.matches import Matches
from ..utils.options import MapperOptions
from ..utils.timer import StageTimers
from ..ops.device_index import DeviceFMSet, to_device
from ..pipeline.dis_mapper import DreamIndex, _finish_batch, _sub_batch
from ..pipeline.map_step import max_seed_len_static, uniform_len_ok
from ..pipeline.seeding import max_errors_for_batch, rate_to_ppm
from ..ops.device_index import DeviceFM
from .dist_mapper import (META_ROW_BITS, MeshMapOut, decode_flat_device,
                          decode_routing, fetch_mesh_outs, mesh_local_step,
                          pack_batch_blob, pack_route_words, place_filter,
                          shard_db)
from .mesh import make_mesh, visible_devices


class MeshDreamMapper:
    """Maps batches against all bins of `index` with the flat multi-bin
    step on a (data, bin) mesh of devices: `mesh` as
    parallel/mesh.py::make_mesh lays it out, or `n_devices` places on the
    visible devices of the index's kind, or the index's device alone. The
    devices must be of the index's kind: the fallbacks and mate rescue run
    on the index's device."""

    POOL_MAX = 1 << (META_ROW_BITS - 1)   # slot rows must fit the meta row field
    MAX_DRAIN = 6   # override passes for pool overflow before the host re-map

    def __init__(self, index: DreamIndex, opts: MapperOptions,
                 mesh=None, n_devices: int | None = None,
                 r_cap: int | None = None, lean: bool = False):
        self.index = index
        self.opts = opts
        if mesh is None:
            mesh = make_mesh(n_devices or 1, index.n_bins,
                             visible_devices(index.device) if n_devices
                             else [index.device])
        self.mesh = mesh
        for dev in self.mesh.reshape(-1):
            if dev.type != index.device.type:
                # the fallbacks and mate rescue run on the index's device
                raise ValueError(f"mesh device {dev} differs in kind from "
                                 f"the index's {index.device}")
        self.data_ax, self.bin_ax = self.mesh.shape
        self.device = self.mesh[0, 0]
        self.mesh_shape = {"data": self.data_ax, "bin": self.bin_ax}
        # pad to the bin axis with empty bins (n = 0: searches find nothing)
        self.B = ((index.n_bins + self.bin_ax - 1) // self.bin_ax) * self.bin_ax
        self.B_loc = self.B // self.bin_ax
        self.r_cap_arg = r_cap
        fms = list(index.fms)
        # lean=True leaves bwt/occ as placeholders: the flat step reads the
        # fused rows only
        arrs = DeviceFMSet.build_np(fms, [st.text for st in index.stores],
                                    pad_bins_to=self.B, lean=lean)
        self.fmsets = shard_db(self.mesh, arrs)
        self.fmset = self.fmsets[0, 0]       # bin shard 0 (all bins if bin_ax = 1)
        self.prefix_q = self.fmset.prefix_q
        self.sample_rate = fms[0].sample_rate if fms else 1

        # per distinct device: (words, slack)
        self.filters, self.filter_kw = place_filter(
            index.filter if index.filter_type != "none" else None,
            self.mesh.reshape(-1), lambda dev: index.device_filter(dev, self.B))
        self.use_filter = self.filter_kw["use_filter"]
        self.filter_words, self.slack_table = self.filters.get(self.device,
                                                               (None, None))
        self._seen_loc_f = self._seen_v_f = None
        self._tuned_r_cap = 0
        self.fallback_diag = {"spill_bins": 0, "route_ovf": 0, "seed_ovf": 0,
                              "routed": 0, "drain_passes": 0}

    def _r_cap(self, half_loc: int) -> int:
        """Shared slot-pool capacity of a device: about one route per read
        plus IBF false positives, with 1.25x headroom; every read to every
        bin without a filter. Persistent overflow grows it (_tuned_r_cap)."""
        if self.r_cap_arg is not None:
            return min(self.r_cap_arg, self.POOL_MAX)
        base = max(256, min(2 * half_loc,
                            (5 * half_loc // 4 + self.bin_ax - 1) // self.bin_ax))
        if not self.use_filter:
            base = min(half_loc * ((self.B + self.bin_ax - 1) // self.bin_ax),
                       self.POOL_MAX)
        return min(self.POOL_MAX, max(base, self._tuned_r_cap))

    def _step(self, half_loc: int, L: int, r_cap: int, rate_ppm: int,
              max_err: int, max_slen: int, uniform_len: bool,
              cap2l: float, cap2v_f: float):
        assert r_cap <= self.POOL_MAX, "slot pool exceeds the meta row field"
        return functools.partial(
            mesh_local_step, half_loc=half_loc, L=L, B=self.B, r_cap=r_cap,
            rate_ppm=rate_ppm, max_errors=max_err, capacity=8,
            max_slen=max_slen, prefix_q=self.prefix_q,
            sample_rate=self.sample_rate, cap2v=max(8, int(cap2v_f * r_cap)),
            uniform_len=uniform_len, slack_table=self.slack_table,
            cap2l=cap2l, **self.filter_kw)

    def _run_pass(self, step, blobs, words=None):
        """Queue one pass of `step` on every mesh place; `blobs[d]` and
        `words[d]` map a device to data shard d's upload there. Returns the
        closure that waits for and assembles the pass's MeshMapOut."""
        outs = []
        for d in range(self.data_ax):
            row = []
            for j in range(self.bin_ax):
                dev = self.mesh[d, j]
                fw, slack = self.filters.get(dev, (None, None))
                row.append(step(self.fmsets[d, j], fw, blobs[d][dev],
                                None if words is None else words[d][dev],
                                slack_table=slack, bin_col0=j * self.B_loc))
            outs.append(row)
        return fetch_mesh_outs(outs)

    def _upload_shards(self, arr: np.ndarray) -> list[dict]:
        """Split `arr` (int32 view) evenly over the data shards and place
        shard d once on each distinct device of mesh row d."""
        per = arr.shape[0] // self.data_ax
        return [{dev: to_device(arr[d * per : (d + 1) * per], dev)
                 for dev in dict.fromkeys(self.mesh[d])}
                for d in range(self.data_ax)]

    # --- locate/verify lane-cap tuning -------------------------------------
    #
    # The locate budget (cap2l * t_cap lanes) and the verify budget (cap2v *
    # t_cap lanes) default to DY_CAP2L = 4.0 and DY_CAP2V = 1.25. Every pass
    # reports its true demands (v_need, loc_need), so after the first batch
    # the caps shrink to margin * observed maximum, rounded up to a quantum
    # and never above the defaults; an undersized batch still completes
    # through the spill and overflow fallbacks. A set env knob pins its cap;
    # DY_TUNE_CAPS=0 turns tuning off.
    _Q = 0.25
    _MARGIN_L = 1.3
    _MARGIN_V = 1.5

    def _caps(self) -> tuple[float, float]:
        def _default(env, dflt):
            v = os.environ.get(env)
            return (float(v) if v is not None else dflt), v is not None

        cap2l, l_fixed = _default("DY_CAP2L", 4.0)
        cap2v, v_fixed = _default("DY_CAP2V", 1.25)
        if os.environ.get("DY_TUNE_CAPS", "1") == "0":
            return cap2l, cap2v

        def _quant(x, lo, hi):
            q = -(-x // self._Q) * self._Q
            return float(min(hi, max(lo, q)))

        if not l_fixed and self._seen_loc_f is not None:
            cap2l = _quant(self._MARGIN_L * self._seen_loc_f, self._Q, cap2l)
        if not v_fixed and self._seen_v_f is not None:
            cap2v = _quant(self._MARGIN_V * self._seen_v_f, self._Q, cap2v)
        return cap2l, cap2v

    def _observe_demand(self, out: MeshMapOut, r_cap: int) -> None:
        t = float(max(r_cap, 1))
        self._seen_loc_f = max(self._seen_loc_f or 0.0,
                               float(np.max(out.loc_need)) / t)
        self._seen_v_f = max(self._seen_v_f or 0.0, float(np.max(out.v_need)) / t)
        self.fallback_diag["loc_f"] = round(self._seen_loc_f, 3)
        self.fallback_diag["v_f"] = round(self._seen_v_f, 3)

    def map_batch(self, batch: ReadBatch,
                  timers: StageTimers | None = None) -> Matches:
        """All matches in global int64 coordinates."""
        return self.map_batch_async(batch, timers)()

    def map_batch_async(self, batch: ReadBatch,
                        timers: StageTimers | None = None):
        """Queue the batch's step now; return a drain() closure that waits,
        decodes and runs the drain passes and fallbacks."""
        timers = timers or StageTimers()
        n = batch.n_reads
        L = batch.max_len
        rate_ppm = rate_to_ppm(self.opts.error_rate)
        max_err = max(1, max_errors_for_batch(L, self.opts.error_rate))
        blob, half_loc = pack_batch_blob(batch.seqs[:n], batch.lengths,
                                         self.data_ax, L)
        r_cap = self._r_cap(half_loc)
        step = self._step(half_loc, L, r_cap, rate_ppm, max_err,
                          max_seed_len_static(L, rate_ppm),
                          uniform_len_ok(batch.lengths, L, rate_ppm, max_err),
                          *self._caps())
        blob_d = self._upload_shards(blob.view(np.int32))
        with timers.stage("mesh map enqueue (host)"):
            fetch = self._run_pass(step, blob_d)
        return lambda: self._collect(batch, fetch, n, half_loc, r_cap, timers,
                                     blob_d, step)

    def _collect(self, batch, fetch, n, half_loc, r_cap, timers, blob_d,
                 step) -> Matches:
        index, diag = self.index, self.fallback_diag
        parts: list[Matches] = []
        n_pad = self.data_ax * half_loc
        drains = 0
        while True:
            with timers.stage("mesh fetch (device wait)"):
                out = fetch()
            routing = decode_routing(out.route_words, n, self.B)
            if drains == 0:            # drains re-route the same pairs
                diag["routed"] += int(routing.sum())
            # every pass feeds the cap tuner, drain passes too
            self._observe_demand(out, r_cap)
            leftover = self._process_out(batch, out, routing, n, half_loc,
                                         r_cap, n_pad, parts, timers,
                                         count_ovf=(drains == 0))
            if not leftover.any():
                break
            if drains >= self.MAX_DRAIN:
                # drain budget spent: exact single-bin re-map of the rest
                for b in np.flatnonzero(leftover[:n].any(axis=0)):
                    if b >= index.n_bins:       # padding bins hold nothing
                        continue
                    with timers.stage("mesh overflow fallback (host)"):
                        self._fallback(batch, b, np.flatnonzero(leftover[:n, b]),
                                       int(index.contigs.bin_starts[b]), parts,
                                       timers)
                break
            # drain: re-submit only the leftover pairs through the same step
            drains += 1
            diag["drain_passes"] += 1
            words = self._upload_shards(
                pack_route_words(leftover, self.B).view(np.int32))
            with timers.stage("mesh map enqueue (host)"):
                fetch = self._run_pass(step, blob_d, words)
        if drains >= 2 and self.r_cap_arg is None:
            # persistent overflow: grow the default pool for later batches
            self._tuned_r_cap = min(self.POOL_MAX,
                                    max(self._tuned_r_cap, 2 * r_cap))
        return Matches.concat(parts)

    def _process_out(self, batch, out: MeshMapOut, routing, n, half_loc,
                     r_cap, n_pad, parts, timers, count_ovf=True):
        """Decode one pass; returns the (n_pad, B) routing of the pairs
        beyond each device's pool."""
        index, diag = self.index, self.fallback_diag
        B_loc = self.B_loc
        bin_starts = index.contigs.bin_starts
        leftover = np.zeros((n_pad, self.B), dtype=bool)
        fb_by_bin: dict[int, list] = {}
        for j in range(self.bin_ax):
            for d in range(self.data_ax):
                with timers.stage("mesh collect (host)"):
                    m, fb, lo_pairs, spilled = decode_flat_device(
                        out, j, d, routing, half_loc, B_loc, r_cap,
                        self.opts.sensitivity)
                if spilled:
                    # the verify compaction spilled: re-map this device's
                    # routed pairs through the exact single-bin path
                    diag["spill_bins"] += 1
                    with timers.stage("mesh spill fallback (host)"):
                        for lb in range(B_loc):
                            b = j * B_loc + lb
                            if b >= index.n_bins:
                                continue
                            sub = routing[d * half_loc : min((d + 1) * half_loc, n), b]
                            ids = np.flatnonzero(sub) + d * half_loc
                            if len(ids):
                                self._fallback(batch, b, ids, int(bin_starts[b]),
                                               parts, timers)
                    continue
                lr, lb_ = lo_pairs
                if len(lr):
                    leftover[lr, j * B_loc + lb_] = True
                    if count_ovf:      # unique pairs: first pass only
                        diag["route_ovf"] += len(lr)
                # seed-hit overflow: the exact re-map of the pair replaces its
                # pool matches, which the decoder dropped
                fr, fbin = fb
                for b_loc in np.unique(fbin):
                    ids = fr[fbin == b_loc]
                    diag["seed_ovf"] += len(ids)
                    fb_by_bin.setdefault(j * B_loc + int(b_loc), []).append(ids)
                if m is not None:
                    bin_g = j * B_loc + m["bin_local"]
                    off = bin_starts[np.minimum(bin_g, len(bin_starts) - 1)]
                    parts.append(Matches(
                        read_id=m["read_id"].astype(np.int32),
                        strand=m["strand"], begin=m["begin"] + off,
                        end=m["end"] + off, dist=m["dist"]))
        for b, idss in sorted(fb_by_bin.items()):
            ids = np.unique(np.concatenate(idss))
            with timers.stage("mesh overflow fallback (host)"):
                self._fallback(batch, b, ids, int(bin_starts[b]), parts, timers)
        return leftover

    def _fallback(self, batch: ReadBatch, b: int, ids: np.ndarray, off: int,
                  parts: list[Matches], timers: StageTimers) -> None:
        """Re-map a read subset of bin b through the exact single-bin path,
        on a view of its bin shard's resident stacked set at the common q
        and rate, moved to the index's device where the shard lies on
        another."""
        j, lb = divmod(b, self.B_loc)
        dev_view = lambda: DeviceFM(*(
            None if x is None else x.to(self.index.device)
            for x in self.fmsets[0, j].bin(lb)))
        bm = self.index.bin_mapper(b, self.opts, timers, dev_factory=dev_view,
                                   prefix_q=self.prefix_q,
                                   sample_rate=self.sample_rate)
        m = bm.map_batch(_sub_batch(batch, ids))
        m.begin += off
        m.end += off
        m.read_id = ids[m.read_id].astype(np.int32)
        parts.append(m)


def mesh_dream_sam(mapper: MeshDreamMapper, batch: ReadBatch,
                   cmdline: str = "", timers: StageTimers | None = None,
                   header: bool = True, stats: dict | None = None) -> bytes:
    """The mesh DREAM pipeline -> SAM bytes, finished as dream_map_sam."""
    timers = timers or StageTimers()
    m = mapper.map_batch(batch, timers)
    return _finish_batch(mapper.index, batch, m, mapper.opts, cmdline, timers,
                         header, stats)


def mesh_dream_stream(mapper: MeshDreamMapper, batches, cmdline: str = "",
                      timers: StageTimers | None = None,
                      stats: dict | None = None, header: bool = True):
    """Yield SAM bytes per batch (the first with the header, if `header`).
    A worker thread queues batch i+1's step before draining batch i; the
    caller's thread finishes batch i (rank, rescue, CIGAR, SAM). One batch
    in flight."""
    timers = timers or StageTimers()
    q: Queue = Queue(maxsize=1)
    sentinel = object()
    err: list[BaseException] = []

    def device_worker():
        prev = None
        try:
            for batch in batches:
                cur = (batch, mapper.map_batch_async(batch, timers))
                if prev is not None:
                    p, prev = prev, None
                    q.put((p[0], p[1]()))
                prev = cur
        except BaseException as e:  # handed to the consumer, re-raised there
            err.append(e)
        finally:
            if prev is not None:
                try:
                    q.put((prev[0], prev[1]()))
                except BaseException as e:
                    if not err:
                        err.append(e)
            q.put(sentinel)

    t = threading.Thread(target=device_worker, daemon=True)
    t.start()
    first = header
    while True:
        item = q.get()
        if item is sentinel:
            t.join()
            if err:
                raise err[0]
            return
        batch, m = item
        yield _finish_batch(mapper.index, batch, m, mapper.opts, cmdline,
                            timers, header=first, stats=stats)
        first = False
