#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dream_yara_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's config-1 single-end path, its config-2 paired-end DREAM
path, its repeat-rich path (sampled SA, repetitive re-seed strata), its
flat multi-bin path on config-5 (256 bins, --mesh on one card), its
multi-device layer (the (data, bin) mesh on 2 and 4 logical shards of the
card, one bin's tables sharded over 2 and 4 logical shards, the
multi-process runtime through the CLI, the entry points) and its mapper
CLI, at full size, and fails (non-zero exit, no result line) on
any error, when no CUDA device is present, or when the port cannot be
imported. Phases:

  1. card     — the card's name and power limit, its clocks and the host's
                CPU (nvidia-smi, /proc/cpuinfo); the card's clocks are
                sampled again during each timed verify phase and stream;
  2. build    — nvcc builds the three kernels from csrc/ and g++ the port's six
                native host libraries from native/, all at once (ptxas
                lines; fails if a native library does not build);
  3. gather   — the row-gather kernel against its plain edition, exact
                equality, at the probe shape of each TPU kernel it replaces,
                at the config-2 and repeat-rich paths' shapes and on edge
                indices; both times from CUDA events, in turns, beside
                index_select's and the bound;
  4. verify   — the banded-verify kernel against its plain edition at the
                config-1 (L=100, E=3) and config-2 (L=150, E=4) shapes, at
                L=250/E=12 and on edge lanes, each time beside its bound;
                then its stacked-text entry at
                the config-5 shape (256 bins, 78,125 lanes), on edge layouts
                of unequal bins, and with one bin against the single-bin
                entry;
  5. chunk    — a map-step chunk on the CPU and on the card (bundles
                identical) and the full chunk with no host sync, config-1
                and config-2 shapes;
  6. config-1 — a 4.6 Mbp genome (seed 12345) and 4 x 65,536 simulated
                100 bp reads (bench.py's workload) streamed through
                dream_map_stream; a 256-read subsample is checked against
                the golden model; then the same bin row-sharded over 2 and 4
                logical shards of the card (ShardedBinMapper), one batch at
                sensitivity full, matches identical to BinMapper's;
  7. config-2 — 8 bins x 5.8 Mbp (seed 2024) with a 2^31-bit blocked IBF
                and 4 x 125,000 simulated 150 bp pairs
                (tools/bench_config2.py's workload) streamed through
                dream_map_stream: both kernels launched, every read routed
                to its bin, >= 99 % mapped; a 1,024-pair subsample gives
                the same SAM bytes on the card and on the CPU; 16,384 pairs
                through the flat step (MeshDreamMapper) give the per-bin SAM;
  8. rep-rich — one 32 Mbp repeat-rich bin at sample rate 8 with its
                bidirectional sidecar, 100 bp reads half from repeat copies
                (tools/bench_bidir_ab.py's workload) at the default options:
                the sampled locate equal to the full SA, one repetitive
                group per backend and budget identical on the card and on
                the CPU, the approximate seed-search kernel against its
                plain edition at the chr21 cells' group shapes (exact, both
                timed in turns, the rank rows it fetched against the
                lockstep's), 4 x 25,000 reads streamed (>= 99 % mapped, both
                backends' groups run), SAM identical on the sampled and the
                full SA and between card and CPU, a profile of one group
                per backend;
  9. config-5 — 256 bins x 400,000 bp (seed 52) with a blocked IBF and
                Zipf-routed 100 bp reads (tools/bench_config5.py's
                workload): one flat step of a 50,000-read batch identical
                on CPU and card and free of host syncs, its time, memory
                and profile; 4 x 50,000 reads streamed through
                mesh_dream_stream (>= 99 % mapped);
                one batch through the per-bin path, SAM byte-identical;
                1,024 reads give the same SAM on the card and on the CPU;
                then the mesh on 2 and 4 logical shards of the card
                (make_mesh(nd, 256, ["cuda:0"])): one batch each,
                SAM identical to the one-shard stream's, a shard's step
                free of host syncs;
 10. cli      — the port's indexer and build-filter write a 4-bin database
                (subprocesses); the port's CLI maps SE and PE FASTQ in a
                subprocess on the card, default path and --mesh, each
                output equal to the in-process SAM, and reports its kernel
                launches; then the same CLI as rank 0 of a one-process
                torch.distributed run (--coordinator) and as two ranks on
                the one card, SAM identical;
 11. entry    — graft_entry.entry("cuda") runs its step, and
                dryrun_multichip(4, "cuda") passes its five scenarios;
 12. result   — the kernel table and the device line as JSON.

Every number printed is measured in this run, on the card named beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from dream_yara_tpu_torch.verify_bench import (REPS, STACKED_SHAPES,
                                               SHAPES as VERIFY_SHAPES,
                                               ClockSampler, bound, card_line,
                                               host_line, time_ms)

GENOME_LEN = 4_600_000
READ_LEN = 100
ERROR_RATE = 0.03
BATCH = 65_536
N_BATCHES = 4
CHUNK_READS = 8_192
GOLDEN_READS = 256

C2_BINS = 8
C2_BIN_LEN = 5_800_000
C2_READ_LEN = 150
C2_LL, C2_LD = 350, 80
C2_BATCH_PAIRS = 125_000
C2_N_BATCHES = 4
C2_SUB_PAIRS = 1_024

RR_GENOME_LEN = 32_000_000   # tools/bench_bidir_ab.py's bin and reads
RR_READ_LEN = 100
RR_BATCH = 25_000
RR_N_BATCHES = 4             # streamed once after one warm-up batch
RR_LOCATE_ROWS = 1 << 20
RR_SAM_READS = 2_048
RR_CPU_READS = 256

C5_BINS = 256                # tools/bench_config5.py's database and reads
C5_BIN_LEN = 400_000
C5_BATCH = 50_000
C5_N_BATCHES = 4             # streamed once after one warm-up batch
C5_CPU_READS = 1_024
C2_MESH_PAIRS = 16_384
CLI_BINS = 4
CLI_BIN_LEN = 200_000
CLI_READS = 2_000
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)

# (what, TPU kernel it replaces or None, rows, int32 words a row, queries,
#  index dtype): the probe shape of each TPU kernel, then the config-2
#  path's shapes: one rank trip of a 65,536-read chunk (2 rows x 5 seeds x
#  2 bounds) and one classify chunk of block rows; then the repeat-rich
#  path's: one stratum-2 enumeration trip (2 bounds x 2,048 seeds x 1,129
#  layouts) and one LF step of a chunk's locate walk (131,072 rows x 4
#  seeds x 8 hits) over a 32 Mbp bin's fused rows
GATHER_SHAPES = (
    ("_vmem_kernel probe", "tools/proto_pallas_rank.py:46", 36_000, 24, 1 << 20, "int32"),
    ("_dma_kernel probe", "tools/proto_pallas_rank.py:78", 36_000, 128, 1 << 20, "int32"),
    ("_ring_kernel probe", "tools/proto_probe_dma.py:64", 3_145_728, 128, 1_001_472, "int32"),
    ("config-2 fused rank rows", None, 45_314, 24, 1_310_720, "int32"),
    ("config-2 IBF block rows", None, 524_288, 64, 4_194_304, "int64"),
    ("rep-rich stratum-2 trip", "tools/proto_pallas_rank.py:46", 250_002, 24,
     4_624_384, "int32"),
    ("rep-rich locate step", "tools/proto_pallas_rank.py:46", 250_002, 24,
     4_194_304, "int32"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def in_turns(plain, kernel, plain_reps: int, kernel_reps: int):
    """Times (ms) in turns plain, kernel, kernel, plain."""
    p1 = time_ms(plain, plain_reps)
    k1 = time_ms(kernel, kernel_reps)
    k2 = time_ms(kernel, kernel_reps)
    p2 = time_ms(plain, plain_reps)
    return k1, k2, p1, p2


def launch_counts(*keys) -> dict:
    """Launches since the last reset of the given kernel entries (all by
    default): the single-bin and the stacked verify entry, the row gather,
    the approximate seed search."""
    from dream_yara_tpu_torch.ops import (approx_search_cuda, banded_verify_cuda,
                                          row_gather_cuda)

    v = banded_verify_cuda.kernel
    counts = {"banded_verify": v.launches - v.stacked_launches,
              "banded_verify_stacked": v.stacked_launches,
              "row_gather": row_gather_cuda.kernel.launches,
              "approx_search": approx_search_cuda.kernel.launches}
    return {k: counts[k] for k in (keys or counts)}


def reset_launch_counts() -> None:
    from dream_yara_tpu_torch.ops import (approx_search_cuda, banded_verify_cuda,
                                          row_gather_cuda)

    banded_verify_cuda.kernel.launches = 0
    banded_verify_cuda.kernel.stacked_launches = 0
    row_gather_cuda.kernel.launches = 0
    approx_search_cuda.kernel.launches = 0


def sub_batch(batch, ids, paired=False):
    from dream_yara_tpu_torch.io.readstore import ReadBatch

    n = batch.n_reads
    return ReadBatch(names=[batch.names[i] for i in ids],
                     seqs=batch.seqs[np.concatenate([ids, n + ids])],
                     lengths=batch.lengths[ids],
                     quals=[batch.quals[i] for i in ids], paired=paired)


def phase_build() -> None:
    """The kernel libraries (one nvcc each) and the port's native host
    libraries (one g++ each), all started together. A native library that
    does not build fails the run: the streams are timed on the native host
    path."""
    from dream_yara_tpu_torch.native import build as native
    from dream_yara_tpu_torch.ops.approx_search_cuda import kernel as approx_k
    from dream_yara_tpu_torch.ops.banded_verify_cuda import kernel as verify_k
    from dream_yara_tpu_torch.ops.row_gather_cuda import kernel as gather_k

    t0 = time.perf_counter()
    kernels = (verify_k, gather_k, approx_k)
    jobs = [k.build for k in kernels] + [
        (lambda name=name: native.build(name)) for name in native.LIBS]
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        paths = list(ex.map(lambda job: job(), jobs))
    missing = [name for name, p in zip(native.LIBS, paths[len(kernels):])
               if p is None]
    if missing:
        raise RuntimeError(f"native host libraries did not build: {missing}")
    log(f"[build] {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.1f} s (native host libraries: "
        f"{', '.join(native.LIBS)}, from dream_yara_tpu_torch/native/)")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build] {k.source.name}: {line.strip()}")


def phase_gather(card):
    """The row-gather kernel against its plain edition. Returns its kernel
    table entries, one for each TPU kernel it replaces, timed at that
    kernel's probe shape."""
    import torch

    from dream_yara_tpu_torch.ops import row_gather
    from dream_yara_tpu_torch.ops.row_gather_cuda import kernel

    dev = torch.device("cuda")
    entries = []
    worst = 0
    for what, replaces, nb, W, Q, idt in GATHER_SHAPES:
        g = torch.Generator(device=dev).manual_seed(nb * 131 + W)
        table = torch.randint(-2**31, 2**31 - 1, (nb, W), dtype=torch.int32,
                              generator=g, device=dev)
        idx = torch.randint(0, nb, (Q,), dtype=getattr(torch, idt),
                            generator=g, device=dev)
        got = kernel(table, idx)
        want = row_gather.gather_rows(table, idx)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"gather kernel disagrees at {what}: {err}")
        k1, k2, p1, p2 = in_turns(lambda: row_gather.gather_rows(table, idx),
                                  lambda: kernel(table, idx), 10, 10)
        lib = time_ms(lambda: torch.index_select(table, 0, idx), 10)
        # bytes: each distinct row read once, the indices read, rows written
        distinct = int(torch.unique(idx.long().clamp(0, nb - 1)).numel())
        nbytes = (distinct + Q) * W * 4 + Q * idx.element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        mb = nb * W * 4 / 2**20
        log(f"[gather] {what}: table {nb} x {W} int32 ({mb:.1f} MiB), "
            f"{Q} {idt} queries: exact (max |kernel - plain| = {err}); "
            f"kernel {k1} / {k2} ms = {Q / k1 * 1e3:.4g} rows/s, "
            f"plain {p1} / {p2} ms = {Q / p1 * 1e3:.4g} rows/s, index_select "
            f"{lib} ms; bound {bound} ms ({nbytes} bytes, {distinct} distinct "
            f"rows), kernel at {100 * bound / k1:.1f} % of it ({card})")
        if replaces is not None:
            entries.append({"name": "row_gather", "route": "cuda",
                            "source": "dream_yara_tpu_torch/csrc/row_gather.cu",
                            "replaces": replaces, "shape": what,
                            "ms": k1, "plain_ms": p1, "bound_ms": bound,
                            "bound_by": "bytes", "library_ms": lib})
        del table, idx, got, want
    torch.cuda.empty_cache()

    # edge and out-of-range indices at every width the port uses (fused rank
    # rows 24, IBF blocks 64, probe rows 128; the sharded bin's prefix pairs
    # 4, SA rows 8 and text blocks 32)
    for W in (24, 64, 128, 4, 8, 32):
        for idt in (torch.int32, torch.int64):
            nb = 1000
            g = torch.Generator(device=dev).manual_seed(W)
            table = torch.randint(-2**31, 2**31 - 1, (nb, W), dtype=torch.int32,
                                  generator=g, device=dev)
            info = torch.iinfo(idt)
            idx = torch.tensor([0, nb - 1, -1, nb, nb + 5, -nb, info.max,
                                info.min, 3, 999], dtype=idt, device=dev)
            got, want = kernel(table, idx), row_gather.gather_rows(table, idx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"gather kernel disagrees on edge "
                                     f"indices (W={W}, {idt})")
    log("[gather] edge and out-of-range indices (0, nb-1, -1, nb, int min/max) "
        "clamp as in the plain edition at W = 24, 64, 128, 4, 8, 32, int32 and "
        "int64")
    for e in entries:
        e["max_abs_err"] = worst
    return entries


def phase_verify(text_np, card):
    """The banded-verify kernel against its plain edition; returns its
    kernel-table entry."""
    import torch

    from dream_yara_tpu_torch.ops import verify
    from dream_yara_tpu_torch.ops.banded_verify_cuda import kernel
    from dream_yara_tpu_torch.verify_cases import edge_case, verify_case

    dev = torch.device("cuda")
    text = torch.from_numpy(text_np).to(dev)
    rng = np.random.default_rng(7)
    worst = 0
    timing = None
    with ClockSampler() as clocks:
        for C, L, E, edges in VERIFY_SHAPES:
            case = verify_case(rng, text_np, C, L, E)
            if edges:
                case = edge_case(text_np, *case)
            anchors, reads, rows, lengths = (torch.from_numpy(a).to(dev) for a in case)
            got = kernel(text, anchors, reads, rows, lengths, E)
            want = verify.banded_verify(text, anchors, reads, rows, lengths, E)
            torch.cuda.synchronize()
            errs = [int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)]
            worst = max(worst, *errs)
            ok_lanes = int((want[0] <= E).sum())
            log(f"[verify] C={C} L={L} E={E} edges={edges}: max |kernel - plain| "
                f"dist/begin/end = {errs} (tolerance: exact, integer outputs); "
                f"lanes within E: {ok_lanes}/{C}")
            if any(errs):
                raise AssertionError(f"kernel disagrees with the plain edition at "
                                     f"C={C} L={L} E={E}: {errs}")
            if not edges:
                args = (text, anchors, reads, rows, lengths, E)
                k1, k2, p1, p2 = in_turns(lambda: verify.banded_verify(*args),
                                          lambda: kernel(*args), 3, REPS)
                b_ms, b_by, nbytes, ops = bound(case[3], E, False)
                log(f"[verify] C={C} L={L} E={E}: kernel {k1} ms then {k2} ms, "
                    f"plain {p1} ms then {p2} ms; bound {b_ms} ms by {b_by} "
                    f"({nbytes} bytes, {ops} operations), kernel at "
                    f"{100 * b_ms / k1:.1f} % of it ({card})")
                if (C, L, E) == (131_072, 100, 3):
                    timing = (k1, p1, b_ms, b_by)
    log(f"[verify] card {clocks.summary()} ({card})")
    # no PyTorch call computes a banded edit distance: library_ms is null
    return {"name": "banded_verify", "route": "cuda",
            "source": "dream_yara_tpu_torch/csrc/banded_verify.cu",
            "replaces": "dream_yara_tpu/ops/pallas_verify.py:30",
            "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
            "bound_ms": timing[2], "bound_by": timing[3], "library_ms": None}


def _no_sync(fn):
    """Run fn on the card with the sync debug mode on; returns (out, syncs)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [w for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]


def phase_chunk(label, store, fm, batch, L, error_rate, card):
    """A CHUNK_READS chunk through the map step on the CPU and on the card
    (identical bundles), then the full 65,536-read chunk on the card: no
    host sync inside the step, and its time."""
    import torch

    from dream_yara_tpu_torch.ops.device_index import DeviceFM, to_device
    from dream_yara_tpu_torch.ops.readpack import pack_blob_with_lengths
    from dream_yara_tpu_torch.pipeline.map_step import (
        max_seed_len_static, single_bin_map_step_packed, uniform_len_ok)
    from dream_yara_tpu_torch.pipeline.seeding import (max_errors_for_batch,
                                                       rate_to_ppm)

    rate_ppm = rate_to_ppm(error_rate)
    max_err = max(1, max_errors_for_batch(L, error_rate))
    devs = {name: torch.device(name) for name in ("cpu", "cuda")}
    dfm = {name: DeviceFM.from_host(fm, store.text, d) for name, d in devs.items()}

    def step_args(half):
        ids = np.arange(half)
        lens = batch.lengths[ids].astype(np.int32)
        blob = pack_blob_with_lengths(batch.seqs[ids], lens, half, L).view(np.int32)
        kw = dict(half=half, L=L, rate_ppm=rate_ppm, max_errors=max_err,
                  capacity=8, max_slen=max_seed_len_static(L, rate_ppm),
                  prefix_q=fm.prefix_q, compact_cap=2 * half,
                  uniform_len=uniform_len_ok(lens, L, rate_ppm, max_err))
        return blob, kw

    blob, kw = step_args(CHUNK_READS)
    outs = {}
    for name, d in devs.items():
        blob_d = to_device(blob, d)
        t0 = time.perf_counter()
        if name == "cuda":
            out, syncs = _no_sync(lambda: single_bin_map_step_packed(
                dfm[name], blob_d, **kw))
        else:
            out, syncs = single_bin_map_step_packed(dfm[name], blob_d, **kw), []
        outs[name] = [x.cpu().numpy() for x in out]
        log(f"[chunk] {label} {name}: map step on {CHUNK_READS} reads in "
            f"{time.perf_counter() - t0:.3f} s (host clock, incl. fetch); "
            f"host syncs flagged inside the step: {len(syncs)}")
        if syncs:
            raise AssertionError(f"the map step synchronised: {syncs[0].message}")
    for k, (a, b) in enumerate(zip(outs["cpu"], outs["cuda"])):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{label} chunk output {k} differs between "
                                 f"CPU and CUDA")
    log(f"[chunk] {label}: CPU and CUDA bundles identical "
        f"({len(outs['cpu'][0])} words; seed arrays {outs['cpu'][1].shape})")

    blob, kw = step_args(BATCH)
    blob_d = to_device(blob, devs["cuda"])
    _, syncs = _no_sync(lambda: single_bin_map_step_packed(dfm["cuda"], blob_d, **kw))
    if syncs:
        raise AssertionError(f"the {label} map step synchronised: {syncs[0].message}")
    ms = time_ms(lambda: single_bin_map_step_packed(dfm["cuda"], blob_d, **kw), 3)
    log(f"[chunk] {label} chunk ({BATCH} reads, {2 * BATCH} rows, L={L}, "
        f"E={max_err}): {ms} ms on the card, 0 host syncs in the step ({card})")
    return dfm["cuda"], blob_d, kw


def profile_step(label, fn, card) -> None:
    """Device time by kernel for one call (torch.profiler; device-side
    kernel events only, so no time is counted twice)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(t for t, _, _ in rows)
    if total == 0:
        log(f"[profile] {label}: the profiler saw no device time (not measured)")
        return
    rows.sort(reverse=True)
    share = ""
    for name in ("row_gather_kernel", "banded_verify_kernel"):
        t = sum(t for t, k, _ in rows if name in k)
        if t:
            share += f"; {name} {t / 1e3:.3f} ms = {100 * t / total:.1f} %"
    log(f"[profile] {label}: {total / 1e3:.3f} ms of device kernels, "
        f"{sum(n for _, _, n in rows)} launches{share} ({card})")
    for t, k, n in rows[:8]:
        log(f"[profile]   {t / 1e3:9.3f} ms  x{n:<5d} {k[:90]}")


def simulate_reads(store, n_reads: int):
    """bench.py's read simulator: 100 bp windows with 0-3 substitutions,
    every other read reverse-complemented (seed 999)."""
    from dream_yara_tpu_torch.io.readstore import ReadBatch
    from dream_yara_tpu_torch.utils.alphabet import revcomp

    rng = np.random.default_rng(999)
    text = store.text
    pos = rng.integers(0, GENOME_LEN - READ_LEN, size=n_reads)
    reads = []
    for i in range(n_reads):
        r = text[pos[i] : pos[i] + READ_LEN].copy()
        for _ in range(int(rng.integers(0, 4))):
            j = int(rng.integers(0, READ_LEN))
            r[j] = (r[j] + int(rng.integers(1, 4))) % 4
        if i % 2:
            r = revcomp(r)
        reads.append(r)
    return ReadBatch.from_reads([f"r{i}" for i in range(n_reads)], reads)


def phase_config1(store, fm, batches, card):
    import torch

    from dream_yara_tpu_torch.golden.golden_mapper import golden_map_se
    from dream_yara_tpu_torch.utils.options import MapperOptions
    from dream_yara_tpu_torch.utils.timer import StageTimers
    from dream_yara_tpu_torch.pipeline.dis_mapper import (DreamIndex,
                                                          dream_map_sam,
                                                          dream_map_stream)
    from dream_yara_tpu_torch.pipeline.mapper import map_single_bin, single_bin_sam

    dev = torch.device("cuda")
    opts = MapperOptions(error_rate=ERROR_RATE, secondary_matches="tag")
    index = DreamIndex([store], [fm], None, "none", device=dev)
    t0 = time.perf_counter()
    dream_map_sam(index, batches[0], opts, header=False)    # index upload, warm-up
    torch.cuda.synchronize()
    log(f"[config-1] warm-up batch (index upload + first batch): "
        f"{time.perf_counter() - t0:.3f} s")

    n_total = sum(b.n_reads for b in batches)
    timers = StageTimers()
    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with ClockSampler() as clocks:
        t0 = time.perf_counter()
        sams = list(dream_map_stream(index, iter(batches), opts, timers=timers,
                                     stats=stats))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_records = sum(sum(1 for line in s.split(b"\n") if line and line[:1] != b"@")
                    for s in sams)
    log(f"[config-1] {n_total} reads in {wall:.3f} s = {n_total / wall:.1f} reads/s "
        f"({card}); SAM records {n_records}; mapped {stats['mapped']}, "
        f"unique {stats['unique']}")
    log(f"[config-1] card {clocks.summary()} during the stream ({card})")
    log(f"[config-1] peak device memory {peak} bytes ({peak / 2**20:.1f} MiB) ({card})")
    log(f"[config-1] stage timers ({card}):\n{timers.report()}")
    log(f"[config-1] kernel launches in the stream: {launches}")
    if n_records < n_total:
        raise AssertionError(f"{n_records} SAM records for {n_total} reads")
    if min(launches["banded_verify"], launches["row_gather"]) == 0:
        raise AssertionError(f"the config-1 stream skipped a kernel: {launches}")
    if "overflow fallback" in timers.totals:
        raise AssertionError("a seed overflowed its capacity")
    if stats["mapped"] < 0.99 * n_total:
        raise AssertionError(f"only {stats['mapped']} of {n_total} reads mapped")

    # the golden model on a subsample: exact matches, c1 and c2 per read
    ids = np.arange(GOLDEN_READS)
    sub = sub_batch(batches[0], ids)
    ranked, _, _ = map_single_bin(store, fm, sub, opts, dev)
    golden = golden_map_se(store, fm, sub, error_rate=ERROR_RATE)
    m = ranked.matches
    for rid in range(sub.n_reads):
        got = [(int(m.dist[i]), int(m.begin[i]), int(m.end[i]), int(m.strand[i]))
               for i in np.flatnonzero(m.read_id == rid)]
        g = golden[rid]
        if got != list(g.matches) or int(ranked.c1[rid]) != g.c1 \
                or int(ranked.c2[rid]) != g.c2:
            raise AssertionError(f"read {rid}: port {got} != golden {g.matches}")
    # and the stream's own records for those reads are the same bytes
    recs = lambda s: [l for l in s.split(b"\n") if l and l[:1] != b"@"]
    if recs(sams[0])[:GOLDEN_READS] != recs(single_bin_sam(store, fm, sub, opts, dev)):
        raise AssertionError("stream SAM records differ from the subsample's")
    log(f"[config-1] golden model agrees on {GOLDEN_READS} reads (matches, c1, "
        f"c2), and the stream's records for them are identical")
    return launches


def held_against_plain(step, card, label):
    """Run one sharded step with every kernel launch it makes held against
    the plain edition on the launch's own inputs: each row gather of each
    shard (ops/row_gather.py; shard-local indices, negative and past the
    end for the rows a shard does not own) and the stacked verify entry on
    the windows cut from fetched blocks (ops/verify.py; one text row a
    lane). Fails on any difference; then times the verify call and the
    largest gather of each row width against their plain editions."""
    from unittest import mock

    import torch

    from dream_yara_tpu_torch.ops import (banded_verify_cuda, row_gather,
                                          row_gather_cuda, verify)
    from dream_yara_tpu_torch.parallel import sharded_fm
    from dream_yara_tpu_torch.pipeline import map_step

    gathers, verifies = {}, []

    def gather(table, idx):
        got = row_gather_cuda.gather_rows(table, idx)
        g = gathers.setdefault(table.shape[1], dict(calls=0, bad=0, out=0, big=None))
        g["calls"] += 1
        g["bad"] = g["bad"] + (got != row_gather.gather_rows(table, idx)).sum()
        g["out"] = g["out"] + ((idx < 0) | (idx >= table.shape[0])).sum()
        if g["big"] is None or idx.numel() > g["big"][1].numel():
            g["big"] = (table, idx)
        return got

    def banded(*args, **kw):
        got = banded_verify_cuda.banded_verify(*args, **kw)
        want = verify.banded_verify(*args, **kw)
        errs = [(a.long() - b.long()).abs().max() for a, b in zip(got, want)]
        verifies.append((args, kw, errs, (want[0] <= args[5]).sum()))
        return got

    with mock.patch.object(sharded_fm, "gather_rows", gather), \
            mock.patch.object(map_step, "banded_verify", banded):
        step()
    torch.cuda.synchronize()
    if not verifies or not gathers:
        raise AssertionError(f"{label}: the step launched no kernel to hold")
    for args, kw, errs, ok_lanes in verifies:
        text, anchors, reads, rows, lengths, E = args
        errs = [int(e) for e in errs]
        k1, k2, p1, p2 = in_turns(lambda: verify.banded_verify(*args, **kw),
                                  lambda: banded_verify_cuda.kernel(*args, **kw),
                                  3, REPS)
        b_ms, b_by, nbytes, ops = bound(lengths.cpu().numpy(), E, True)
        log(f"[sharded] {label} verify, stacked entry with a text row a lane: "
            f"B = C = {text.shape[0]}, rows of {text.shape[1]}, L="
            f"{reads.shape[1]} E={E}: max |kernel - plain| dist/begin/end = "
            f"{errs} (tolerance: exact); lanes within E: {int(ok_lanes)}; kernel "
            f"{k1} ms then {k2} ms, plain {p1} ms then {p2} ms; bound {b_ms} ms "
            f"by {b_by} ({nbytes} bytes, {ops} operations) ({card})")
        if any(errs):
            raise AssertionError(f"{label}: the stacked verify entry disagrees "
                                 f"with the plain edition on the step's own "
                                 f"windows: {errs}")
    for W, g in sorted(gathers.items()):
        table, idx = g["big"]
        k1, k2, p1, p2 = in_turns(lambda: row_gather.gather_rows(table, idx),
                                  lambda: row_gather_cuda.kernel(table, idx), 10, 10)
        log(f"[sharded] {label} gathers at W={W}: {g['calls']} launches, "
            f"{int(g['out'])} indices outside their shard, {int(g['bad'])} words "
            f"differ from the plain edition (tolerance: exact); the largest, "
            f"table {table.shape[0]} x {W} int32 and {idx.numel()} {idx.dtype} "
            f"queries: kernel {k1} ms then {k2} ms, plain {p1} ms then {p2} ms "
            f"({card})")
        if int(g["bad"]):
            raise AssertionError(f"{label}: the gather kernel disagrees with the "
                                 f"plain edition at W={W} on the step's own "
                                 f"indices")
    if not {4, 8, 24, 32} <= set(gathers):
        raise AssertionError(f"{label}: a sharded table was not read: widths "
                             f"{sorted(gathers)}")


def phase_sharded(store, fm, batch, card):
    """The config-1 bin row-sharded over K = 2 and 4 logical shards of the
    card (parallel/sharded_fm.py): one 65,536-read batch at sensitivity
    full, matches identical to BinMapper's; every table read goes through
    the gather kernel on each shard and the DP through the verify kernel's
    stacked entry (windows cut from fetched blocks); every launch of one
    step is held against its plain edition. Returns the launches of each K."""
    import torch

    from dream_yara_tpu_torch.ops.device_index import to_device
    from dream_yara_tpu_torch.parallel.sharded_fm import ShardedBinMapper
    from dream_yara_tpu_torch.pipeline.map_step import (max_seed_len_static,
                                                        uniform_len_ok)
    from dream_yara_tpu_torch.pipeline.mapper import BinMapper
    from dream_yara_tpu_torch.pipeline.seeding import rate_to_ppm
    from dream_yara_tpu_torch.utils.options import MapperOptions

    dev = torch.device("cuda:0")
    opts = MapperOptions(error_rate=ERROR_RATE, sensitivity="full")
    key = lambda m: np.stack([m.read_id, m.strand, m.begin, m.end, m.dist])[
        :, np.lexsort((m.dist, m.end, m.begin, m.strand, m.read_id))]
    t0 = time.perf_counter()
    want = key(BinMapper(store, fm, opts, dev).map_batch(batch))
    torch.cuda.synchronize()
    log(f"[sharded] BinMapper, {batch.n_reads} reads at sensitivity full: "
        f"{want.shape[1]} matches in {time.perf_counter() - t0:.3f} s (host "
        f"clock, with the index upload)")
    rate_ppm = rate_to_ppm(ERROR_RATE)
    launches = {}
    for K in (2, 4):
        sm = ShardedBinMapper(fm, store.text, [dev] * K, opts=opts)
        per_shard = sum(t[0].numel() * t[0].element_size()
                        for t in (sm.dev["fused"], sm.dev["sa8"], sm.dev["tb"],
                                  sm.dev["pfx4"]))
        reset_launch_counts()
        t0 = time.perf_counter()
        got = key(sm.map_batch(batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[K] = launch_counts()
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"sharded K={K}: matches differ from BinMapper's")
        if min(launches[K][k] for k in ("banded_verify_stacked", "row_gather")) == 0 \
                or launches[K]["banded_verify"]:
            raise AssertionError(f"sharded K={K}: kernel launches {launches[K]}")
        step = sm._step(rate_ppm=rate_ppm, max_errors=3, capacity=8,
                        max_slen=max_seed_len_static(READ_LEN, rate_ppm),
                        prefix_q=sm.db.prefix_q, compact_cap=2 * batch.n_reads,
                        uniform_len=uniform_len_ok(batch.lengths, READ_LEN,
                                                   rate_ppm, 3))
        reads_d = to_device(batch.seqs, dev)
        lens_d = to_device(batch.lengths, dev)
        _, syncs = _no_sync(lambda: step(reads_d, lens_d))
        if syncs:
            raise AssertionError(f"the sharded step synchronised: {syncs[0].message}")
        held_against_plain(lambda: step(reads_d, lens_d), card, f"K={K}")
        reset_launch_counts()
        step(reads_d, lens_d)
        per_step = launch_counts()
        ms = time_ms(lambda: step(reads_d, lens_d), 3)
        log(f"[sharded] K={K} logical shards of cuda:0: {got.shape[1]} matches "
            f"identical to BinMapper's; map_batch {wall:.3f} s (host clock) = "
            f"{batch.n_reads / wall:.1f} reads/s; one step of {batch.n_reads} "
            f"reads {ms} ms on the card, 0 host syncs, launches a step "
            f"{per_step}; tables a shard {per_shard} bytes "
            f"({per_shard / 2**20:.1f} MiB) ({card})")
        del sm, step, reads_d, lens_d
        torch.cuda.empty_cache()
    return launches


def build_config2():
    """tools/bench_config2.py's database: 8 random bins of 5.8 Mbp from
    default_rng(2024), an FM index each, and a 2^31-bit blocked canonical
    IBF (3 hashes, k = 19) over them."""
    from dream_yara_tpu_torch.index.fmindex import FMIndex
    from dream_yara_tpu_torch.index.ibf import InterleavedBloomFilter
    from dream_yara_tpu_torch.io.seqstore import SeqStore

    t0 = time.perf_counter()
    rng = np.random.default_rng(2024)
    genomes = [rng.integers(0, 4, C2_BIN_LEN).astype(np.int8)
               for _ in range(C2_BINS)]
    stores = [SeqStore.from_seqs([f"chr{b}"], [g]) for b, g in enumerate(genomes)]
    fms = [FMIndex.build(stores[0].text)]      # builds the native libraries once
    with ThreadPoolExecutor(max_workers=C2_BINS - 1) as ex:
        fms += list(ex.map(lambda st: FMIndex.build(st.text), stores[1:]))
    t1 = time.perf_counter()
    ibf = InterleavedBloomFilter.create(C2_BINS, size_bits=1 << 31, n_hashes=3,
                                        k=19)
    for b, g in enumerate(genomes):
        ibf.add_kmers(g, b)
    log(f"[config-2] {C2_BINS} bins x {C2_BIN_LEN} bp, FM indexes (q="
        f"{fms[0].prefix_q}) in {t1 - t0:.1f} s, IBF ({ibf.words.nbytes} bytes, "
        f"blocked={ibf.blocked}, canonical={ibf.canonical}) in "
        f"{time.perf_counter() - t1:.1f} s (host)")
    return genomes, stores, fms, ibf


def make_pairs(genomes, n_pairs, rng):
    """tools/bench_config2.py's pair simulator: 150 bp FR pairs with insert
    lengths within 350 +- 80 and 0-4 substitutions per mate. Returns the
    paired batch and each pair's bin."""
    from dream_yara_tpu_torch.io.readstore import ReadBatch

    b_of = rng.integers(0, C2_BINS, n_pairs)
    tlen = rng.integers(C2_LL - C2_LD + 10, C2_LL + C2_LD - 10, n_pairs)
    p = rng.integers(0, C2_BIN_LEN - (C2_LL + C2_LD), n_pairs)
    m1 = np.empty((n_pairs, C2_READ_LEN), dtype=np.int8)
    m2 = np.empty((n_pairs, C2_READ_LEN), dtype=np.int8)
    win = np.arange(C2_READ_LEN)
    for b in range(C2_BINS):
        sel = np.flatnonzero(b_of == b)
        g = genomes[b]
        m1[sel] = g[p[sel, None] + win[None, :]]
        starts2 = p[sel] + tlen[sel] - C2_READ_LEN
        r2 = g[starts2[:, None] + win[None, :]]
        m2[sel] = np.where(r2[:, ::-1] < 4, 3 - r2[:, ::-1], r2[:, ::-1])
    for m in (m1, m2):
        nsub = rng.integers(0, 5, n_pairs)
        for s in range(1, 5):
            rows = np.flatnonzero(nsub >= s)
            cols = rng.integers(0, C2_READ_LEN, len(rows))
            m[rows, cols] = (m[rows, cols] + rng.integers(1, 4, len(rows))) % 4
    names = [f"p{i}" for i in range(n_pairs)]
    batch = ReadBatch.from_dense(names * 2, np.concatenate([m1, m2]),
                                 np.full(2 * n_pairs, C2_READ_LEN, np.int32),
                                 paired=True)
    return batch, b_of


def phase_config2(card):
    import torch

    from dream_yara_tpu_torch.utils.options import MapperOptions
    from dream_yara_tpu_torch.utils.timer import StageTimers
    from dream_yara_tpu_torch.ops.ibf_query import ibf_classify_packed
    from dream_yara_tpu_torch.ops.readpack import pack_blob_with_lengths
    from dream_yara_tpu_torch.ops.device_index import to_device
    from dream_yara_tpu_torch.pipeline.dis_mapper import (IBF_READS, DreamIndex,
                                                          classify_reads,
                                                          dream_map_sam,
                                                          dream_map_stream)
    from dream_yara_tpu_torch.pipeline.map_step import single_bin_map_step_packed

    genomes, stores, fms, ibf = build_config2()
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    made = [make_pairs(genomes, C2_BATCH_PAIRS, rng) for _ in range(C2_N_BATCHES)]
    batches = [b for b, _ in made]
    log(f"[config-2] simulated {C2_N_BATCHES} x {C2_BATCH_PAIRS} pairs in "
        f"{time.perf_counter() - t0:.1f} s")

    dfm, blob_d, kw = phase_chunk("config-2", stores[0], fms[0], batches[0],
                                  C2_READ_LEN, ERROR_RATE, card)
    profile_step("config-2 map-step chunk (65,536 reads)",
                 lambda: single_bin_map_step_packed(dfm, blob_d, **kw), card)
    del dfm, blob_d

    dev = torch.device("cuda")
    opts = MapperOptions(error_rate=ERROR_RATE, library_length=C2_LL,
                         library_deviation=C2_LD, secondary_matches="tag")
    index = DreamIndex(stores, fms, ibf, "bloom", device=dev)
    t0 = time.perf_counter()
    dream_map_sam(index, batches[0], opts, header=False)  # uploads, warm-up
    torch.cuda.synchronize()
    log(f"[config-2] warm-up batch (index and filter upload + first batch): "
        f"{time.perf_counter() - t0:.3f} s")

    words, block_s, _ = index.device_filter()
    ids = np.arange(IBF_READS)
    b0 = batches[0]
    blob = pack_blob_with_lengths(b0.seqs[ids], b0.lengths[ids], IBF_READS,
                                  C2_READ_LEN)
    cblob = to_device(blob.view(np.int32), dev)
    profile_step(f"config-2 classify call ({IBF_READS} reads)",
                 lambda: ibf_classify_packed(
                     words, cblob, None, half=IBF_READS, L=C2_READ_LEN,
                     k=ibf.k, n_hashes=ibf.n_hashes, rate_ppm=300,
                     canonical=True, blocked=True, n_bins=C2_BINS,
                     block_s=block_s), card)

    n_total = sum(b.n_reads for b in batches)
    timers = StageTimers()
    stats: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with ClockSampler() as clocks:
        t0 = time.perf_counter()
        n_records = 0
        for sam in dream_map_stream(index, iter(batches), opts, timers=timers,
                                    stats=stats):
            n_records += sum(1 for line in sam.split(b"\n")
                             if line and line[:1] != b"@")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[config-2] {n_total} reads ({n_total // 2} pairs) in {wall:.3f} s = "
        f"{n_total / wall:.1f} reads/s ({card}); SAM records {n_records}; "
        f"mapped {stats['mapped']} ({100 * stats['mapped'] / n_total:.3f} %), "
        f"unique {stats['unique']}, proper pairs {stats['proper_pairs']}")
    log(f"[config-2] card {clocks.summary()} during the stream ({card})")
    log(f"[config-2] peak device memory {peak} bytes ({peak / 2**20:.1f} MiB) ({card})")
    log(f"[config-2] stage timers ({card}):\n{timers.report()}")
    log(f"[config-2] kernel launches in the stream: {launches}")
    if n_records < n_total:
        raise AssertionError(f"{n_records} SAM records for {n_total} reads")
    if min(launches["banded_verify"], launches["row_gather"]) == 0:
        raise AssertionError(f"the config-2 stream skipped a kernel: {launches}")
    if "overflow fallback" in timers.totals:
        raise AssertionError("a seed overflowed its capacity")
    if stats["mapped"] < 0.99 * n_total:
        raise AssertionError(f"only {stats['mapped']} of {n_total} reads mapped")

    # routing: every mate has <= 4 substitutions with E = 4, so the k-mer
    # lemma routes it to its own bin
    routed, n_bins_total = 0, 0
    for batch, b_of in made:
        mask = classify_reads(index, batch, opts)
        truth = np.concatenate([b_of, b_of])
        missed = np.flatnonzero(~mask[np.arange(batch.n_reads), truth])
        if len(missed):
            raise AssertionError(f"{len(missed)} reads not routed to their "
                                 f"bin, e.g. read {missed[0]}")
        routed += batch.n_reads
        n_bins_total += int(mask.sum())
    log(f"[config-2] every one of {routed} reads routed to its true bin; "
        f"mean bins per read {n_bins_total / routed:.5f}")

    # the card against the port's own CPU run on a subsample
    pids = np.arange(C2_SUB_PAIRS)
    sub = sub_batch(batches[0], np.concatenate(
        [pids, C2_BATCH_PAIRS + pids]), paired=True)
    card_sam = dream_map_sam(index, sub, opts, cmdline="sub")
    t0 = time.perf_counter()
    cpu_index = DreamIndex(stores, fms, ibf, "bloom", device=torch.device("cpu"))
    cpu_sam = dream_map_sam(cpu_index, sub, opts, cmdline="sub")
    if card_sam != cpu_sam:
        raise AssertionError("config-2 subsample SAM differs between the card "
                             "and the CPU")
    log(f"[config-2] {C2_SUB_PAIRS}-pair subsample: SAM identical on the card "
        f"and on the CPU ({len(card_sam)} bytes; CPU run "
        f"{time.perf_counter() - t0:.1f} s)")
    del cpu_index
    phase_config2_mesh(index, opts, batches[0], card)
    return launches


def build_rep_rich():
    """tools/bench_bidir_ab.py's bin and reads: a 32 Mbp repeat-rich genome
    from default_rng(42) (1,600 diverged 300 bp interspersed copies, 64
    tandem arrays, 16 N-runs), its FM index with the q = 10 prefix table
    (the full SA kept for the checks, and the rate-8 sampled index the
    bench maps with), the reverse fused rows, and 100 bp reads with up to
    2 substitutions from default_rng(7), every other one from a repeat copy.
    Returns (store, fm_full, fm8, rfused, batches, truth, regions), the
    last the repeat copies' and tandem arrays' intervals."""
    from dream_yara_tpu_torch.index.bifm import build_reverse_fused
    from dream_yara_tpu_torch.index.fmindex import FMIndex
    from dream_yara_tpu_torch.io.readstore import ReadBatch
    from dream_yara_tpu_torch.io.seqstore import SeqStore
    from dream_yara_tpu_torch.utils.simulate import repeat_rich_genome, sample_reads

    t0 = time.perf_counter()
    g, ann = repeat_rich_genome(np.random.default_rng(42), RR_GENOME_LEN,
                                alu_count=RR_GENOME_LEN // 20_000,
                                tandem_loci=RR_GENOME_LEN // 500_000,
                                n_runs=RR_GENOME_LEN // 2_000_000)
    store = SeqStore.from_seqs(["rich"], [g])
    t1 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex:
        reverse = ex.submit(build_reverse_fused, store.text)
        fm_full = FMIndex.build(store.text, prefix_q=10)
        rfused = reverse.result()[0]
    fm8 = fm_full.subsample_sa(8)
    t2 = time.perf_counter()
    n_reads = (RR_N_BATCHES + 1) * RR_BATCH
    reads, truth = sample_reads(np.random.default_rng(7), store.text[:-1],
                                n_reads, read_len=RR_READ_LEN, n_sub=2,
                                regions=ann["alu"] + ann["tandem"])
    batches = [ReadBatch.from_reads([f"r{i}" for i in range(b0, b0 + RR_BATCH)],
                                    reads[b0 : b0 + RR_BATCH])
               for b0 in range(0, n_reads, RR_BATCH)]
    log(f"[rep-rich] genome {RR_GENOME_LEN} bp in {t1 - t0:.1f} s; FM index "
        f"(q={fm_full.prefix_q}, sample rate {fm8.sample_rate}: "
        f"{len(fm8.sa)} samples) and reverse rows in {t2 - t1:.1f} s; "
        f"{n_reads} reads in {time.perf_counter() - t2:.1f} s (host)")
    return store, fm_full, fm8, rfused, batches, truth, ann["alu"] + ann["tandem"]


# the chr21 cells' repetitive groups (port_bench/configs/chr21-8bins.json:
# REP_PAD rows, error rate 0.03): (cell, stratum, read length, max errors,
# budget, indels, window)
APPROX_SHAPES = (("pe150", 1, 150, 4, 1, True, 32),
                 ("se100", 1, 100, 3, 1, True, 32),
                 ("pe150", 2, 150, 4, 2, False, 16),
                 ("se100", 2, 100, 3, 2, False, 16))


def group_seeds(lens: np.ndarray, rate_ppm: int, max_err: int, budget: int):
    """repetitive_map_step's seeds of a group of rows 0..K-1 with lengths
    `lens`: ceil((E+1)/(budget+1)) windows a row, (rows, starts, slens)."""
    from dream_yara_tpu_torch.pipeline.seeding import errors_for

    ns2_max = (max_err + budget + 1) // (budget + 1)
    e = errors_for(lens.astype(np.int64), rate_ppm)
    ns2 = np.repeat((e + budget + 1) // (budget + 1), ns2_max)
    sidx = np.tile(np.arange(ns2_max), len(lens))
    slen = np.where(ns2 > 0, np.repeat(lens, ns2_max) // np.maximum(ns2, 1), 0)
    rows = np.repeat(np.arange(len(lens)), ns2_max)
    return (rows.astype(np.int32), (sidx * slen).astype(np.int32),
            np.where(sidx < ns2, slen, 0).astype(np.int32))


def plain_with_rows(dfm, args, m: int, budget: int, indels: bool):
    """The plain edition's outputs, and the distinct fused rows the kernel
    reads for the same seeds: the rows of every lane the lockstep updates
    at some trip (active, its interval not empty). Before its branch step
    a lane holds the exact lane's interval, so these are the rows of the
    kernel's fetches, each counted once."""
    import torch

    from dream_yara_tpu_torch.ops import approx_search as tas
    from dream_yara_tpu_torch.ops.rank import BLOCK

    reads, rows, starts, slens = args
    kind = torch.from_numpy(tas._layout_tables(m, budget, indels)[0]).to(
        rows.device)[None, :]
    lane_len = tas._lane_len(slens.clamp(max=m)[:, None], kind).reshape(-1)
    seen = torch.zeros(dfm.fused.shape[0], dtype=torch.bool, device=rows.device)
    trip = [0]
    rank_fused = tas.rank_fused

    def recording(fused, c, i):
        Q = i.shape[0] // 2
        live = (trip[0] < lane_len) & (i[:Q] < i[Q:])
        seen[i[:Q][live] // BLOCK] = True
        seen[i[Q:][live] // BLOCK] = True
        trip[0] += 1
        return rank_fused(fused, c, i)

    tas.rank_fused = recording
    try:
        out = tas._seed_search_edits_plain(dfm.fused, dfm.counts, dfm.n, *args,
                                           m, budget=budget, indels=indels)
    finally:
        tas.rank_fused = rank_fused
    return out, int(seen.sum())


def phase_approx_search(dfm, store, regions, card):
    """The approximate seed-search kernel against its plain edition (which
    runs the lockstep on the card through the row gather) at the chr21
    cells' group shapes: REP_PAD reads from repeat copies with up to 2
    substitutions, every row real (the cells' groups run 60-78 % full).
    Exact equality; both timed in turns; the rank rows the kernel fetched
    against the lockstep's. Its bound: each byte read once and written
    once at 3.35 TB/s (the distinct fused rows its lanes read, the seeds
    and their windows, the outputs); the log line adds the rows it fetched
    x 96 B at that rate, which the kernel beats where the rows sit in the
    L2. Returns the kernel-table entries."""
    import torch

    from dream_yara_tpu_torch.ops import approx_search as tas
    from dream_yara_tpu_torch.ops import approx_search_cuda, row_gather_cuda
    from dream_yara_tpu_torch.pipeline.mapper import BinMapper
    from dream_yara_tpu_torch.pipeline.seeding import rate_to_ppm
    from dream_yara_tpu_torch.utils.simulate import sample_reads

    dev = torch.device("cuda")
    rate_ppm = rate_to_ppm(ERROR_RATE)
    K = BinMapper.REP_PAD
    entries = []
    for cell, stratum, L, max_err, budget, indels, m in APPROX_SHAPES:
        reads, _ = sample_reads(np.random.default_rng(L), store.text[:-1], 2 * K,
                                read_len=L, n_sub=2, regions=regions)
        reads = np.stack(reads[::2]).astype(np.int8)      # the repeat copies
        rows, starts, slens = group_seeds(np.full(K, L), rate_ppm, max_err,
                                          budget)
        args = [torch.from_numpy(a).to(dev) for a in (reads, rows, starts, slens)]
        fetched = torch.zeros(1, dtype=torch.int64, device=dev)
        kernel = lambda rr=None: tas.seed_search_edits(
            dfm.fused, dfm.counts, dfm.n, *args, m, budget=budget,
            indels=indels, rank_rows=rr)
        plain = lambda: tas._seed_search_edits_plain(
            dfm.fused, dfm.counts, dfm.n, *args, m, budget=budget, indels=indels)
        before = (approx_search_cuda.kernel.launches,
                  row_gather_cuda.kernel.launches)
        got = kernel(fetched)
        torch.cuda.synchronize()
        launches = (approx_search_cuda.kernel.launches - before[0],
                    row_gather_cuda.kernel.launches - before[1])
        want, distinct = plain_with_rows(dfm, args, m, budget, indels)
        diff = [nm for nm, g, w in zip(["lo", "hi", "valid", "w_start"], got, want)
                if not torch.equal(g, w)]
        if diff or launches != (1, 0):
            raise AssertionError(f"approx search kernel at {cell} stratum "
                                 f"{stratum}: differs in {diff}, launches "
                                 f"(kernel, row gather) {launches}")
        S, NL = got[0].shape
        rows_k = int(fetched)
        lockstep = tas.lockstep_rank_rows(S, m, budget, indels)
        del got, want
        k1, k2, p1, p2 = in_turns(plain, kernel, 3, 20)
        nbytes = distinct * 96 + S * (12 + m) + S * NL * 9 + S * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows_ms = rows_k * 96 / HBM_BYTES_PER_S * 1e3
        log(f"[approx] {cell} stratum {stratum} group: S {S} seeds x NL {NL} "
            f"layouts (m {m}, budget {budget}, indels {indels}), {L} bp reads "
            f"from repeat copies: exact, 1 launch, 0 row gathers; kernel "
            f"{k1} / {k2} ms, plain {p1} / {p2} ms ({p1 / k1:.1f}x); rank rows "
            f"{rows_k} of the lockstep's {lockstep} "
            f"({100 * rows_k / lockstep:.2f} %), {distinct} distinct; bound "
            f"{bound:.5f} ms ({nbytes} "
            f"bytes), kernel at {100 * bound / k1:.2f} % of it; rows fetched x "
            f"96 B at 3.35 TB/s {rows_ms:.4f} ms ({card})")
        entries.append({"name": "approx_search", "route": "cuda",
                        "source": "dream_yara_tpu_torch/csrc/approx_search.cu",
                        "replaces": None,
                        "shape": f"{cell} stratum {stratum}, S {S} x NL {NL}",
                        "ms": k1, "plain_ms": p1, "bound_ms": bound,
                        "bound_by": "bytes", "rank_rows": rows_k})
        del args
    torch.cuda.empty_cache()
    return entries


def planted_share(sams, truth) -> float:
    """Share of SAM records whose read's planted site is the primary
    position or one of its XA alternatives."""
    found = total = 0
    for sam in sams:
        for line in sam.split(b"\n"):
            if not line or line[:1] == b"@":
                continue
            f = line.split(b"\t")
            pos = {int(f[3])}
            for tag in f[11:]:
                if tag.startswith(b"XA:Z:"):
                    pos |= {int(a.split(b",")[1][1:])
                            for a in tag[5:].split(b";") if a}
            found += truth[int(f[0][1:])][0] + 1 in pos
            total += 1
    return found / total


def phase_rep_rich(card):
    """The repeat-rich path on the card; returns the stream's launches and
    the approximate seed-search kernel's table entries."""
    import torch

    from dream_yara_tpu_torch.utils.options import MapperOptions
    from dream_yara_tpu_torch.utils.timer import StageTimers
    from dream_yara_tpu_torch.ops.device_index import DeviceFM, to_device
    from dream_yara_tpu_torch.ops.locate import locate_sampled_fused
    from dream_yara_tpu_torch.ops.readpack import pack_blob_with_lengths
    from dream_yara_tpu_torch.pipeline.dis_mapper import (DreamIndex,
                                                          dream_map_sam,
                                                          dream_map_stream)
    from dream_yara_tpu_torch.pipeline.map_step import (
        max_rep_seed_len_static, max_seed_len_static, repetitive_map_step,
        single_bin_map_step_packed, uniform_len_ok)
    from dream_yara_tpu_torch.pipeline.mapper import CHUNK_SIZES, BinMapper
    from dream_yara_tpu_torch.pipeline.seeding import (max_errors_for_batch,
                                                       rate_to_ppm)

    log(f"[rep-rich] cuts: {RR_N_BATCHES} x {RR_BATCH} reads streamed once "
        f"after a {RR_BATCH}-read warm-up (the bench streams 200,000 reads x 5 "
        f"passes); the product-default mode only (the bench runs 4: enum and "
        f"bidir, indels on and off)")
    store, fm_full, fm8, rfused, batches, truth, regions = build_rep_rich()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    dev8 = DeviceFM.from_host(fm8, store.text, dev, rfused=rfused)
    n = fm8.n

    # 1. the sampled locate against the full SA
    g = torch.Generator(device=dev).manual_seed(8)
    rows = torch.cat([torch.tensor([0, n - 1], dtype=torch.int32, device=dev),
                      torch.randint(0, n, (RR_LOCATE_ROWS,), generator=g,
                                    dtype=torch.int32, device=dev)])
    locate = lambda: locate_sampled_fused(dev8.fused, dev8.counts,
                                          dev8.sa_mark_bits, dev8.sa_rank_ck,
                                          dev8.sa, rows, fm8.sample_rate)
    got = locate().cpu().numpy()
    if not np.array_equal(got, fm_full.sa[rows.cpu().numpy()]):
        raise AssertionError("the sampled locate differs from the full SA")
    log(f"[rep-rich] locate: {len(got)} SA rows (first, last, 2^20 random) "
        f"on the rate-8 SA equal the full SA; {time_ms(locate, 5)} ms a "
        f"call ({card})")

    # 2. one group of overflowing rows, four ways, card against CPU
    opts = MapperOptions(error_rate=ERROR_RATE)
    L, rate_ppm = RR_READ_LEN, rate_to_ppm(ERROR_RATE)
    max_err = max(1, max_errors_for_batch(L, ERROR_RATE))
    batch = batches[0]
    nb = batch.n_reads
    chunk_rows = next(cs for cs in CHUNK_SIZES if 2 * nb <= cs)
    half = chunk_rows // 2
    lens_c = np.zeros(half, np.int32)
    lens_c[:nb] = batch.lengths
    blob = to_device(pack_blob_with_lengths(batch.seqs[:nb], lens_c, half,
                                            L).view(np.int32), dev)
    step_kw = dict(half=half, L=L, rate_ppm=rate_ppm, max_errors=max_err,
                   capacity=8, max_slen=max_seed_len_static(L, rate_ppm),
                   prefix_q=fm8.prefix_q, compact_cap=chunk_rows,
                   uniform_len=uniform_len_ok(batch.lengths, L, rate_ppm,
                                              max_err))
    step = lambda: single_bin_map_step_packed(
        dev8, blob, sample_rate=fm8.sample_rate, **step_kw)
    ovf = step()[3].cpu().numpy().reshape(chunk_rows, max_err + 1)
    over = np.flatnonzero(ovf.sum(axis=1) > 0).astype(np.int32)
    K = BinMapper.REP_PAD
    rb = np.zeros(K, np.int32)
    rb[: min(K, len(over))] = over[:K]
    mask = np.arange(K) < len(over)
    reads_c = np.full((chunk_rows, L), 4, np.int8)
    reads_c[:nb] = batch.seqs[:nb]
    reads_c[half : half + nb] = batch.seqs[nb:]
    log(f"[rep-rich] first batch: {len(over)} of {2 * nb} seq rows overflow "
        f"seed capacity ({100 * len(over) / (2 * nb):.2f} %); group of {K} "
        f"rows, {int(mask.sum())} real")
    msl = max_rep_seed_len_static(L, rate_ppm)
    group_in = {where: (dfm, *(to_device(a, d) for a in (reads_c, lens_c, rb, mask)))
                for where, d, dfm in (
                    ("card", dev, dev8),
                    ("cpu", cpu, DeviceFM.from_host(fm8, store.text, cpu,
                                                    rfused=rfused)))}
    ways = {}
    for backend, budget, indels, t_max in (
            ("enum", 1, True, min(msl, BinMapper.REP1_T)),
            ("enum", 2, False, min(msl, BinMapper.REP2_T)),
            ("bidir", 1, False, min(msl, BinMapper.REP1_T)),
            ("bidir", 2, False, min(msl, BinMapper.REP2_T))):
        kw = dict(rate_ppm=rate_ppm, max_errors=max_err, capacity=4,
                  max_slen_rep=t_max, budget=budget, indels=indels,
                  backend=backend, sample_rate=fm8.sample_rate)
        ways[(backend, budget)] = kw
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        on_card = [x.cpu().numpy() for x in repetitive_map_step(*group_in["card"], **kw)]
        t_card = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        on_cpu = [x.numpy() for x in repetitive_map_step(*group_in["cpu"], **kw)]
        t_cpu = time.perf_counter() - t0
        names = ["row", "begin", "end", "dist", "ok", "n_spilled"]
        diff = [nm for nm, a, b in zip(names, on_card, on_cpu)
                if a.dtype != b.dtype or not np.array_equal(a, b)]
        if diff:
            raise AssertionError(f"repetitive group {backend}/{budget}: card and "
                                 f"CPU differ in {diff}")
        log(f"[rep-rich] group {backend}, budget {budget}, indels {indels}, "
            f"window {t_max}: card and CPU identical (row, begin, end, dist, "
            f"ok, n_spilled); {int(on_card[4].sum())} ok lanes, n_spilled "
            f"{int(on_card[5])}; card {t_card:.3f} s, CPU {t_cpu:.1f} s (host "
            f"clock); peak device memory {peak} bytes ({peak / 2**20:.1f} MiB) "
            f"({card})")
    for key in (("enum", 1), ("enum", 2), ("bidir", 2)):
        profile_step(f"rep-rich repetitive group ({key[0]}, budget {key[1]})",
                     lambda: repetitive_map_step(*group_in["card"], **ways[key]),
                     card)
    approx_entries = phase_approx_search(dev8, store, regions, card)
    dev_full = DeviceFM.from_host(fm_full, store.text, dev)
    step_full = lambda: single_bin_map_step_packed(dev_full, blob, **step_kw)
    log(f"[rep-rich] map-step chunk ({nb} reads, {chunk_rows} rows): "
        f"{time_ms(step, 3)} ms at sample rate {fm8.sample_rate}, "
        f"{time_ms(step_full, 3)} ms on the full SA ({card})")
    del dev_full
    profile_step(f"rep-rich map-step chunk ({nb} reads, sample rate 8)", step, card)
    del group_in, blob

    # 3. the stream
    index = DreamIndex([store], [fm8], None, "none", device=dev,
                       rfused={0: rfused})
    t0 = time.perf_counter()
    dream_map_sam(index, batches[0], opts, header=False)    # upload, warm-up
    torch.cuda.synchronize()
    log(f"[rep-rich] warm-up batch (index upload + first batch): "
        f"{time.perf_counter() - t0:.3f} s")
    n_total = RR_N_BATCHES * RR_BATCH
    timers = StageTimers()
    stats: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with ClockSampler() as clocks:
        t0 = time.perf_counter()
        sams = list(dream_map_stream(index, iter(batches[1:]), opts, timers=timers,
                                     stats=stats))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    groups = {k: v for k, v in timers.counts.items()
              if k.startswith("repetitive stratum")}
    n_groups = {b: sum(v for k, v in groups.items() if f"({b})" in k)
                for b in ("enum", "bidir")}
    log(f"[rep-rich] {n_total} reads in {wall:.3f} s = {n_total / wall:.1f} "
        f"reads/s ({card}); mapped {stats['mapped']} "
        f"({100 * stats['mapped'] / n_total:.3f} %), unique {stats['unique']}; "
        f"planted site among the reported matches for "
        f"{100 * planted_share(sams, truth):.3f} % of reads")
    log(f"[rep-rich] card {clocks.summary()} during the stream ({card})")
    log(f"[rep-rich] peak device memory {peak} bytes ({peak / 2**20:.1f} MiB) ({card})")
    log(f"[rep-rich] stage timers ({card}):\n{timers.report()}")
    log(f"[rep-rich] repetitive groups by stratum and backend: {groups}; "
        f"kernel launches in the stream: {launches}")
    if stats["mapped"] < 0.99 * n_total:
        raise AssertionError(f"only {stats['mapped']} of {n_total} reads mapped")
    if timers.totals.get("repetitive re-seed (device)", 0) <= 0:
        raise AssertionError("the repetitive re-seed pass did not run")
    if min(n_groups.values()) == 0:
        raise AssertionError(f"a seed backend ran no group: {n_groups}")
    if min(launches[k] for k in ("banded_verify", "row_gather",
                                 "approx_search")) == 0:
        raise AssertionError(f"the rep-rich stream skipped a kernel: {launches}")
    if launches["approx_search"] != n_groups["enum"]:
        raise AssertionError(f"{n_groups['enum']} enum groups launched the "
                             f"approximate search {launches['approx_search']} "
                             f"times")

    # 4. SAM: sampled against full SA, and card against CPU
    sub = sub_batch(batches[1], np.arange(RR_SAM_READS))
    sam8 = dream_map_sam(index, sub, opts, cmdline="rep-rich")
    full = DreamIndex([store], [fm_full], None, "none", device=dev,
                      rfused={0: rfused})
    if dream_map_sam(full, sub, opts, cmdline="rep-rich") != sam8:
        raise AssertionError("rep-rich SAM differs between the rate-8 and the "
                             "full SA")
    del full
    log(f"[rep-rich] {RR_SAM_READS}-read subsample: SAM identical on the rate-8 "
        f"and the full SA, both on the card ({len(sam8)} bytes)")
    # sample_reads draws every even read from a repeat copy
    sub = sub_batch(batches[1], np.arange(0, 2 * RR_CPU_READS, 2))
    card_timers = StageTimers()
    card_sam = dream_map_sam(index, sub, opts, cmdline="rep-rich",
                             timers=card_timers)
    t0 = time.perf_counter()
    cpu_index = DreamIndex([store], [fm8], None, "none", device=cpu,
                           rfused={0: rfused})
    if dream_map_sam(cpu_index, sub, opts, cmdline="rep-rich") != card_sam:
        raise AssertionError("rep-rich repeat-region SAM differs between the "
                             "card and the CPU")
    rep_groups = {k: v for k, v in card_timers.counts.items()
                  if k.startswith("repetitive stratum")}
    log(f"[rep-rich] {RR_CPU_READS} repeat-region reads: SAM identical on the "
        f"card and on the CPU ({len(card_sam)} bytes; groups {rep_groups}; CPU "
        f"run {time.perf_counter() - t0:.1f} s)")
    return launches, approx_entries


def phase_stacked_verify(card):
    """The stacked-text verify entry against its plain edition: at the
    config-5 shape (256 bins of 400,000 bp, the verify lanes of a 50,000-read
    batch), on the edge layout of unequal bins, and with one bin against the
    single-bin entry. Returns its kernel-table entry."""
    import torch

    from dream_yara_tpu_torch.ops import verify
    from dream_yara_tpu_torch.ops.banded_verify_cuda import kernel
    from dream_yara_tpu_torch.verify_cases import stacked_case

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    worst, timing, shape = 0, None, None
    with ClockSampler() as clocks:
        for what, lens, C, L, E, edges in STACKED_SHAPES:
            host = stacked_case(rng, lens, C, L, E, edges)
            text, bin_n, lane_bin, anchors, reads, rows, lengths = (
                torch.from_numpy(a).to(dev) for a in host)
            args = (text, anchors, reads, rows, lengths, E)
            got = kernel(*args, lane_bin=lane_bin, bin_n=bin_n)
            want = verify.banded_verify(*args, lane_bin=lane_bin, bin_n=bin_n)
            torch.cuda.synchronize()
            errs = [int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)]
            worst = max(worst, *errs)
            log(f"[stacked] {what}: B={len(lens)} C={C} L={L} E={E}: max |kernel - "
                f"plain| dist/begin/end = {errs} (tolerance: exact); lanes within E: "
                f"{int((want[0] <= E).sum())}/{C}")
            if any(errs):
                raise AssertionError(f"stacked kernel disagrees at {what}: {errs}")
            if not edges:
                kw = dict(lane_bin=lane_bin, bin_n=bin_n)
                k1, k2, p1, p2 = in_turns(lambda: verify.banded_verify(*args, **kw),
                                          lambda: kernel(*args, **kw), 3, REPS)
                b_ms, b_by, nbytes, ops = bound(host[6], E, True)
                log(f"[stacked] {what}: kernel {k1} ms then {k2} ms, plain {p1} ms "
                    f"then {p2} ms; bound {b_ms} ms by {b_by} ({nbytes} bytes, {ops} "
                    f"operations), kernel at {100 * b_ms / k1:.1f} % of it ({card})")
                timing = (k1, p1, b_ms, b_by)
                shape = f"{what}: B={len(lens)}, C={C}, L={L}, E={E}"
            del text, reads
    log(f"[stacked] card {clocks.summary()} ({card})")
    # one bin: the stacked entry equals the single-bin entry
    host = stacked_case(rng, [50_000], 8_192, 100, 3, True)
    text, bin_n, lane_bin, anchors, reads, rows, lengths = (
        torch.from_numpy(a).to(dev) for a in host)
    one = kernel(text, anchors, reads, rows, lengths, 3, lane_bin=lane_bin,
                 bin_n=bin_n)
    single = kernel(text[0], anchors, reads, rows, lengths, 3)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(one, single)):
        raise AssertionError("stacked entry with one bin differs from the "
                             "single-bin entry")
    log("[stacked] B=1: the stacked entry equals the single-bin entry on 8,192 "
        "lanes (edge anchors included)")
    torch.cuda.empty_cache()
    return {"name": "banded_verify_stacked", "route": "cuda",
            "source": "dream_yara_tpu_torch/csrc/banded_verify.cu",
            "replaces": "dream_yara_tpu/ops/pallas_verify.py:30",
            "launcher": "dream_yara_tpu/ops/pallas_verify.py:93",
            "shape": shape,
            "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
            "bound_ms": timing[2], "bound_by": timing[3], "library_ms": None}


def build_config5():
    """tools/bench_config5.py's database: 256 random bins of 400,000 bp from
    default_rng(52), an FM index each, and a blocked canonical IBF of
    12 x 400,000 x 256 bits (3 hashes, k = 19)."""
    from dream_yara_tpu_torch.index.fmindex import FMIndex
    from dream_yara_tpu_torch.index.ibf import InterleavedBloomFilter
    from dream_yara_tpu_torch.io.seqstore import SeqStore

    t0 = time.perf_counter()
    rng = np.random.default_rng(52)
    genomes = [rng.integers(0, 4, C5_BIN_LEN).astype(np.int8)
               for _ in range(C5_BINS)]
    stores = [SeqStore.from_seqs([f"g{b:04d}"], [g]) for b, g in enumerate(genomes)]
    fms = [FMIndex.build(stores[0].text)]
    with ThreadPoolExecutor(max_workers=7) as ex:
        fms += list(ex.map(lambda st: FMIndex.build(st.text), stores[1:]))
    t1 = time.perf_counter()
    bins_padded = ((C5_BINS + 63) // 64) * 64
    ibf = InterleavedBloomFilter.create(C5_BINS,
                                        size_bits=12 * C5_BIN_LEN * bins_padded,
                                        n_hashes=3, k=19)
    for b, g in enumerate(genomes):
        ibf.add_kmers(g, b)
    log(f"[config-5] {C5_BINS} bins x {C5_BIN_LEN} bp, FM indexes (q="
        f"{fms[0].prefix_q}) in {t1 - t0:.1f} s, IBF ({ibf.words.nbytes} bytes, "
        f"blocked={ibf.blocked}, canonical={ibf.canonical}) in "
        f"{time.perf_counter() - t1:.1f} s (host)")
    return genomes, stores, fms, ibf


def make_batch5(genomes, n_reads, rng):
    """tools/bench_config5.py's reads: Zipf-weighted source bins (rank r
    weighs 1 / (r + 1)), 100 bp windows with 0-3 substitutions, every other
    read reverse-complemented."""
    from dream_yara_tpu_torch.io.readstore import ReadBatch
    from dream_yara_tpu_torch.utils.alphabet import revcomp

    B = len(genomes)
    w = 1.0 / np.arange(1, B + 1)
    w /= w.sum()
    srcs = rng.choice(B, size=n_reads, p=w)
    names, reads = [], []
    for i, b in enumerate(srcs):
        p = int(rng.integers(0, C5_BIN_LEN - READ_LEN - 1))
        r = genomes[b][p : p + READ_LEN].copy()
        for _ in range(int(rng.integers(0, 4))):
            j = int(rng.integers(0, READ_LEN))
            r[j] = (r[j] + 1 + int(rng.integers(0, 3))) % 4
        if i % 2:
            r = revcomp(r)
        names.append(f"r{i}b{b}")
        reads.append(r)
    return ReadBatch.from_reads(names, reads)


def phase_flat_chunk(mapper, cpu_mapper, batch, card):
    """One flat mesh step (classify, route, flat map) of a whole batch on
    the CPU and on the card, outputs identical and no host sync on the
    card; its time, its peak memory and its profile."""
    import torch

    from dream_yara_tpu_torch.ops.device_index import to_device
    from dream_yara_tpu_torch.parallel.dist_mapper import pack_batch_blob
    from dream_yara_tpu_torch.pipeline.map_step import (max_seed_len_static,
                                                        uniform_len_ok)
    from dream_yara_tpu_torch.pipeline.seeding import rate_to_ppm

    rate_ppm = rate_to_ppm(ERROR_RATE)
    n = batch.n_reads
    blob, half = pack_batch_blob(batch.seqs[:n], batch.lengths, 1, READ_LEN)
    blob = blob.view(np.int32)
    r_cap = mapper._r_cap(half)
    step = mapper._step(half, READ_LEN, r_cap, rate_ppm, 3,
                        max_seed_len_static(READ_LEN, rate_ppm),
                        uniform_len_ok(batch.lengths, READ_LEN, rate_ppm, 3),
                        *mapper._caps())
    outs = {}
    for name, m in (("cpu", cpu_mapper), ("cuda", mapper)):
        blob_d = to_device(blob, m.device)
        t0 = time.perf_counter()
        if name == "cuda":
            out, syncs = _no_sync(lambda: step(m.fmset, m.filter_words, blob_d))
        else:
            out, syncs = step(m.fmset, m.filter_words, blob_d), []
        outs[name] = [x.cpu().numpy() for x in out]
        log(f"[flat] {name}: flat step on {n} reads (pool {r_cap}) in "
            f"{time.perf_counter() - t0:.3f} s (host clock, incl. fetch); host "
            f"syncs flagged inside the step: {len(syncs)}")
        if syncs:
            raise AssertionError(f"the flat step synchronised: {syncs[0].message}")
    for k, (a, b) in enumerate(zip(outs["cpu"], outs["cuda"])):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"flat step output {k} differs between CPU and CUDA")
    log(f"[flat] CPU and CUDA outputs identical (all {len(outs['cpu'])} fields, "
        f"{int((outs['cpu'][2] < 0).sum())} ok lanes)")
    del outs

    blob_d = to_device(blob, mapper.device)
    run = lambda: step(mapper.fmset, mapper.filter_words, blob_d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = time_ms(run, 3)
    log(f"[flat] full step ({n} reads, pool {r_cap} slots, {2 * r_cap} rows): "
        f"{ms} ms on the card, 0 host syncs; peak memory above the resident set "
        f"{peak} bytes ({peak / 2**20:.1f} MiB) ({card})")
    profile_step(f"config-5 flat step ({n} reads)", run, card)
    return ms


def phase_config5(card):
    """The slice's path: the config-5 database streamed through the flat
    multi-bin step (mesh_dream_stream on one card). Returns its launches."""
    import torch

    from dream_yara_tpu_torch.utils.options import MapperOptions
    from dream_yara_tpu_torch.utils.timer import StageTimers
    from dream_yara_tpu_torch.parallel.dream_mesh import (MeshDreamMapper,
                                                          mesh_dream_sam,
                                                          mesh_dream_stream)
    from dream_yara_tpu_torch.pipeline.dis_mapper import (DreamIndex,
                                                          classify_reads,
                                                          dream_map_stream)
    from dream_yara_tpu_torch.pipeline.mapper import CHUNK_SIZES

    log(f"[config-5] cuts: {C5_N_BATCHES} x {C5_BATCH} reads streamed once after "
        f"one warm-up batch (the bench streams 200,000 reads x 5 passes after "
        f"two warm-ups); widths unchanged")
    genomes, stores, fms, ibf = build_config5()
    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    warm = make_batch5(genomes, C5_BATCH, rng)
    batches = [make_batch5(genomes, C5_BATCH, rng) for _ in range(C5_N_BATCHES)]
    log(f"[config-5] simulated {C5_N_BATCHES + 1} x {C5_BATCH} reads in "
        f"{time.perf_counter() - t0:.1f} s")
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    opts = MapperOptions(error_rate=ERROR_RATE)
    index = DreamIndex(stores, fms, ibf, "bloom", device=dev)
    t0 = time.perf_counter()
    mapper = MeshDreamMapper(index, opts)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    log(f"[config-5] stacked set and filter on the card in "
        f"{time.perf_counter() - t0:.1f} s: {resident} bytes "
        f"({resident / 2**20:.1f} MiB), q={mapper.prefix_q}")
    t0 = time.perf_counter()
    list(mesh_dream_stream(mapper, [warm]))
    torch.cuda.synchronize()
    log(f"[config-5] warm-up batch: {time.perf_counter() - t0:.3f} s; "
        f"fallback_diag {mapper.fallback_diag}")

    cpu_index = DreamIndex(stores, fms, ibf, "bloom", device=cpu)
    cpu_mapper = MeshDreamMapper(cpu_index, opts)
    flat_ms = phase_flat_chunk(mapper, cpu_mapper, warm, card)

    n_total = C5_N_BATCHES * C5_BATCH
    timers = StageTimers()
    stats: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with ClockSampler() as clocks:
        t0 = time.perf_counter()
        sams = list(mesh_dream_stream(mapper, iter(batches), timers=timers,
                                      stats=stats))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    diag = dict(mapper.fallback_diag)
    log(f"[config-5] flat stream: {n_total} reads in {wall:.3f} s = "
        f"{n_total / wall:.1f} reads/s ({card}); mapped {stats['mapped']} "
        f"({100 * stats['mapped'] / n_total:.3f} %), unique {stats['unique']}; "
        f"routed pairs per read {diag['routed'] / (n_total + C5_BATCH):.5f}; "
        f"fallback_diag {diag}")
    log(f"[config-5] card {clocks.summary()} during the flat stream ({card})")
    log(f"[config-5] peak device memory {peak} bytes ({peak / 2**20:.1f} MiB) ({card})")
    log(f"[config-5] stage timers ({card}):\n{timers.report()}")
    log(f"[config-5] kernel launches in the flat stream: {launches}")
    if stats["mapped"] < 0.99 * n_total:
        raise AssertionError(f"only {stats['mapped']} of {n_total} reads mapped")
    if min(launches[k] for k in ("banded_verify_stacked", "row_gather")) == 0:
        raise AssertionError(f"the flat stream skipped a kernel: {launches}")

    # the per-bin path on the first batch (a warm-up run uploads its bins);
    # its device rows: each routed bin's reads padded to a CHUNK_SIZES shape
    def chunk_rows(k: int) -> int:          # BinMapper's chunks of k reads
        cs = next((c for c in CHUNK_SIZES if 2 * k <= c), CHUNK_SIZES[-1])
        return -(-k // (cs // 2)) * cs

    routed = classify_reads(index, batches[0], opts).sum(axis=0)
    rows = sum(chunk_rows(int(k)) for k in routed if k)
    log(f"[config-5] device rows per read: per-bin path {rows / C5_BATCH:.3f} "
        f"({int((routed > 0).sum())} routed bins, chunks of {CHUNK_SIZES}), flat "
        f"path {2 * mapper._r_cap(C5_BATCH) / C5_BATCH:.3f} (the slot pool)")
    list(dream_map_stream(index, [batches[0]], opts))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_bin = list(dream_map_stream(index, [batches[0]], opts))
    torch.cuda.synchronize()
    t_bin = time.perf_counter() - t0
    if per_bin[0] != sams[0]:
        raise AssertionError("config-5 SAM differs between the flat and the "
                             "per-bin path")
    log(f"[config-5] per-bin path (dream_map_stream), one batch: {t_bin:.3f} s = "
        f"{C5_BATCH / t_bin:.1f} reads/s against the flat stream's "
        f"{n_total / wall:.1f}; SAM byte-identical ({len(per_bin[0])} bytes) ({card})")

    sub = sub_batch(batches[1], np.arange(C5_CPU_READS))
    card_sam = mesh_dream_sam(mapper, sub, cmdline="config-5")
    t0 = time.perf_counter()
    if mesh_dream_sam(cpu_mapper, sub, cmdline="config-5") != card_sam:
        raise AssertionError("config-5 SAM differs between the card and the CPU")
    log(f"[config-5] {C5_CPU_READS}-read subsample: flat-path SAM identical on the "
        f"card and on the CPU ({len(card_sam)} bytes; CPU run "
        f"{time.perf_counter() - t0:.1f} s)")
    del cpu_mapper, cpu_index
    nd_launches = phase_mesh_nd(index, opts, warm, batches[0], sams[0],
                                n_total / wall, card)
    return launches, flat_ms, nd_launches


def phase_mesh_nd(index, opts, warm, batch, want_sam, nd1_rate, card):
    """The (data, bin) mesh on nd = 2 and 4 logical shards of the one card
    (the layouts mesh_factors gives, (1, 2) and (1, 4), and (2, 2), which
    shards the reads too): one config-5 batch each after a warm-up batch,
    SAM identical to the one-shard stream's first batch; one shard's step
    runs without a host sync. Returns each layout's launches of its timed
    batch."""
    import torch

    from dream_yara_tpu_torch.parallel.dist_mapper import pack_batch_blob
    from dream_yara_tpu_torch.parallel.dream_mesh import (MeshDreamMapper,
                                                          mesh_dream_sam)
    from dream_yara_tpu_torch.parallel.mesh import make_mesh
    from dream_yara_tpu_torch.pipeline.map_step import (max_seed_len_static,
                                                        uniform_len_ok)
    from dream_yara_tpu_torch.pipeline.seeding import rate_to_ppm

    out = {}
    rate_ppm = rate_to_ppm(ERROR_RATE)
    # two bins' factors give the (2, 2) layout of four places
    for nd, mesh in ((2, make_mesh(2, C5_BINS, ["cuda:0"])),
                     (4, make_mesh(4, C5_BINS, ["cuda:0"])),
                     ("4-2x2", make_mesh(4, 2, ["cuda:0"]))):
        t0 = time.perf_counter()
        mapper = MeshDreamMapper(index, opts, mesh=mesh)
        mesh_dream_sam(mapper, warm)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        reset_launch_counts()
        t0 = time.perf_counter()
        sam = mesh_dream_sam(mapper, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[nd] = launch_counts()
        if sam != want_sam:
            raise AssertionError(f"mesh nd={nd}: SAM differs from the one-shard SAM")
        shards = mapper.data_ax * mapper.bin_ax
        if out[nd]["banded_verify_stacked"] < shards or out[nd]["row_gather"] < shards:
            raise AssertionError(f"mesh nd={nd}: a shard launched no kernel: {out[nd]}")
        # the step of the last shard alone: no host sync inside it
        n = batch.n_reads
        blob, half = pack_batch_blob(batch.seqs[:n], batch.lengths,
                                     mapper.data_ax, READ_LEN)
        r_cap = mapper._r_cap(half)
        step = mapper._step(half, READ_LEN, r_cap, rate_ppm, 3,
                            max_seed_len_static(READ_LEN, rate_ppm),
                            uniform_len_ok(batch.lengths, READ_LEN, rate_ppm, 3),
                            *mapper._caps())
        d, j = mapper.data_ax - 1, mapper.bin_ax - 1
        blob_d = mapper._upload_shards(blob.view(np.int32))[d][mapper.mesh[d, j]]
        run = lambda: step(mapper.fmsets[d, j], mapper.filter_words, blob_d,
                           bin_col0=j * mapper.B_loc)
        _, syncs = _no_sync(run)
        if syncs:
            raise AssertionError(f"a shard's step synchronised: {syncs[0].message}")
        ms = time_ms(run, 3)
        log(f"[mesh nd={nd}] mesh {mapper.mesh_shape} on {shards} logical shards of "
            f"cuda:0: {n} reads in {wall:.3f} s = {n / wall:.1f} reads/s (host "
            f"clock, one batch, no overlap; the one-shard stream ran at "
            f"{nd1_rate:.1f}); SAM identical ({len(sam)} bytes); launches {out[nd]}; "
            f"shard ({d}, {j})'s step (pool {r_cap}) {ms} ms, 0 host syncs; set-up "
            f"and warm-up batch {t_warm:.1f} s; fallback_diag "
            f"{mapper.fallback_diag} ({card})")
        del mapper, step, run, blob_d
        torch.cuda.empty_cache()
    return out


def phase_entry(card):
    """The port's entry points on the card: entry()'s step runs and finds
    its planted reads; the multi-device dry run passes its five scenarios on
    a (2, 2) mesh of logical shards. Returns the launches of both."""
    import torch

    from dream_yara_tpu_torch import graft_entry

    reset_launch_counts()
    t0 = time.perf_counter()
    fn, args = graft_entry.entry("cuda")
    out = fn(*args)
    n_ok = int(out.ok.sum())
    if any(a.device.type != "cuda" for a in (out.ok, args[1])) or n_ok < 128:
        raise AssertionError(f"entry(): {n_ok} verified lanes for 128 reads")
    log(f"[entry] entry('cuda'): the step ran on the card, {n_ok} verified lanes "
        f"for 128 planted reads, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(4, "cuda")
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[entry] dryrun_multichip(4, 'cuda') passed in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches} ({card})")
    if min(launches.values()) == 0:
        raise AssertionError(f"the entry points skipped a kernel: {launches}")
    return launches


def phase_config2_mesh(index, opts, batch, card):
    """Config-2 through the flat step: one batch of C2_MESH_PAIRS pairs
    (PE, rescue, the blocked canonical IBF), SAM equal to the per-bin SAM."""
    import torch

    from dream_yara_tpu_torch.parallel.dream_mesh import (MeshDreamMapper,
                                                          mesh_dream_sam)
    from dream_yara_tpu_torch.pipeline.dis_mapper import dream_map_sam

    pids = np.arange(C2_MESH_PAIRS)
    sub = sub_batch(batch, np.concatenate([pids, batch.n_reads // 2 + pids]),
                    paired=True)
    t0 = time.perf_counter()
    per_bin = dream_map_sam(index, sub, opts, cmdline="c2")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mapper = MeshDreamMapper(index, opts)
    mesh_dream_sam(mapper, sub, cmdline="c2")             # warm-up
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    flat = mesh_dream_sam(mapper, sub, cmdline="c2")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    if flat != per_bin:
        raise AssertionError("config-2 --mesh SAM differs from the per-bin SAM")
    log(f"[config-2 mesh] {C2_MESH_PAIRS} pairs: flat-path SAM identical to the "
        f"per-bin SAM ({len(flat)} bytes); flat {t3 - t2:.3f} s, per-bin "
        f"{t1 - t0:.3f} s (host clock) ({card}); fallback_diag "
        f"{mapper.fallback_diag}")
    del mapper
    torch.cuda.empty_cache()


# The mapper CLI as `python -m dream_yara_tpu_torch.cli.mapper_cli ARGS`
# runs it, followed by the process's kernel launches on stderr.
CLI_RUNNER = """
import json, runpy, sys
sys.argv = ["dream-yara-tpu-torch-mapper", *sys.argv[1:]]
try:
    runpy.run_module("dream_yara_tpu_torch.cli.mapper_cli", run_name="__main__")
finally:
    from chip_smoke import launch_counts
    print("LAUNCHES " + json.dumps(launch_counts()), file=sys.stderr)
"""


def phase_cli(card):
    """The port's CLI tools as a user runs them: a small database written
    by the port's indexer and build-filter (subprocesses), then SE and PE
    FASTQ mapped by the port's mapper CLI on the card (DY_PLATFORM unset),
    default path and --mesh; every output file equals the in-process SAM.
    Returns the kernel launches of the four mapper runs."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from dream_yara_tpu_torch.io.fasta import write_fasta
    from dream_yara_tpu_torch.io.fastq import FastqBatchReader
    from dream_yara_tpu_torch.pipeline.dis_mapper import (DreamIndex,
                                                          dream_map_stream)
    from dream_yara_tpu_torch.utils.options import MapperOptions

    rng = np.random.default_rng(3)
    code = np.frombuffer(b"ACGTN", np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        genomes = [rng.integers(0, 4, CLI_BIN_LEN).astype(np.int8)
                   for _ in range(CLI_BINS)]
        for b, g in enumerate(genomes):
            write_fasta(tmp / f"bin{b}.fa", [f"g{b}"], [g])
        env = {k: v for k, v in os.environ.items() if k != "DY_PLATFORM"}
        env["PYTHONPATH"] = str(Path(__file__).resolve().parent)
        t0 = time.perf_counter()
        for tool, extra in (("indexer", []), ("build_filter", ["-bs", "16m", "-k", "19"])):
            r = subprocess.run([sys.executable, "-m", f"dream_yara_tpu_torch.cli.{tool}",
                                "--bins-dir", str(tmp), "-o", str(tmp / "db"), *extra],
                               env=env, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"the port's {tool} failed:\n{r.stderr}")
        log(f"[cli] the port's indexer and build-filter (subprocesses): {CLI_BINS} "
            f"bins x {CLI_BIN_LEN} bp in {time.perf_counter() - t0:.1f} s")

        def fastq(path, rows, tag):
            with open(path, "wb") as fh:
                for i, r in enumerate(rows):
                    fh.write(b"@%s%d\n%s\n+\n%s\n" % (tag, i, code[r].tobytes(),
                                                      b"I" * len(r)))

        def window(b, p):
            return genomes[b][p : p + READ_LEN].copy()

        b_of = rng.integers(0, CLI_BINS, CLI_READS)
        p_of = rng.integers(0, CLI_BIN_LEN - 400, CLI_READS)
        fastq(tmp / "se.fq", [window(b, p) for b, p in zip(b_of, p_of)], b"s")
        fastq(tmp / "r1.fq", [window(b, p) for b, p in zip(b_of, p_of)], b"p")
        fastq(tmp / "r2.fq", [np.where(w[::-1] < 4, 3 - w[::-1], w[::-1])
                              for w in (window(b, p + 200)
                                        for b, p in zip(b_of, p_of))], b"p")
        index = DreamIndex.load(tmp / "db", device=torch.device("cuda"))
        launches: dict = {}
        for mode, reads in (("SE", ["se.fq"]), ("PE", ["r1.fq", "r2.fq"])):
            for mesh in ([], ["--mesh"]):
                args = ["db", *reads, "-o", "out.sam", "-e", "0.03", "-ll", "300",
                        "-ld", "50", *mesh]
                t0 = time.perf_counter()
                r = subprocess.run([sys.executable, "-c", CLI_RUNNER, *args],
                                   cwd=tmp, env=env, capture_output=True,
                                   text=True, timeout=600)
                if r.returncode != 0:
                    raise AssertionError(f"CLI {mode} {mesh} failed:\n{r.stderr}")
                errs = r.stderr.strip().splitlines()
                for k, n in json.loads(errs[-1].split(" ", 1)[1]).items():
                    launches[k] = launches.get(k, 0) + n
                got = (tmp / "out.sam").read_bytes()
                opts = MapperOptions(error_rate=0.03, library_length=300,
                                     library_deviation=50)
                want = b"".join(dream_map_stream(
                    index, FastqBatchReader(*(str(tmp / f) for f in reads),
                                            batch_size=100_000),
                    opts, cmdline=" ".join(args)))
                if got != want:
                    raise AssertionError(f"CLI {mode} {mesh} output differs from "
                                         f"the in-process SAM")
                log(f"[cli] {mode} {' '.join(mesh) or 'default'}: {len(got)} bytes, "
                    f"identical to the in-process SAM; subprocess "
                    f"{time.perf_counter() - t0:.1f} s; "
                    f"{errs[0]} ({card})")
        log(f"[cli] kernel launches of the four mapper runs: {launches}")

        # the same CLI as the ranks of a torch.distributed run on the card
        import socket

        mh_launches: dict = {}
        reads = ["r1.fq", "r2.fq"]
        for nprocs in (1, 2):
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            common = ["db", *reads, "-e", "0.03", "-ll", "300", "-ld", "50",
                      "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                      str(nprocs)]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-c", CLI_RUNNER, *common, "--process-id", str(r),
                 "-o", f"mh{r}.sam"], cwd=tmp, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True) for r in range(nprocs)]
            try:
                outs = [p.communicate(timeout=600) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for r, (p, (_, err)) in enumerate(zip(procs, outs)):
                if p.returncode != 0:
                    raise AssertionError(f"multihost CLI rank {r} of {nprocs} "
                                         f"failed:\n{err}")
                lines = err.strip().splitlines()
                for k, n in json.loads(lines[-1].split(" ", 1)[1]).items():
                    mh_launches[k] = mh_launches.get(k, 0) + n
            got = (tmp / "mh0.sam").read_bytes()
            want = b"".join(dream_map_stream(
                index, FastqBatchReader(*(str(tmp / f) for f in reads),
                                        batch_size=100_000),
                opts, cmdline=" ".join([*common, "--process-id", "0", "-o",
                                        "mh0.sam"])))
            if got != want:
                raise AssertionError(f"multihost CLI ({nprocs} ranks) output "
                                     f"differs from the in-process SAM")
            log(f"[cli] PE --coordinator, {nprocs} rank(s) on the one card over "
                f"gloo: rank 0's SAM ({len(got)} bytes) identical to the "
                f"in-process SAM; {time.perf_counter() - t0:.1f} s; "
                f"{outs[0][1].strip().splitlines()[0]} ({card})")
        log(f"[cli] kernel launches of the multihost runs: {mh_launches}")
        if min(mh_launches[k] for k in ("banded_verify_stacked", "row_gather")) == 0:
            raise AssertionError(f"the multihost CLI skipped a kernel: {mh_launches}")
    return launches, mh_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from dream_yara_tpu_torch.index.fmindex import FMIndex
    from dream_yara_tpu_torch.io.seqstore import SeqStore

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"[card] {host_line()}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # host work that needs no card runs beside the build
    genome_box: dict = {}

    def make_genome():
        t0 = time.perf_counter()
        genome = np.random.default_rng(12345).integers(0, 4, GENOME_LEN).astype(np.int8)
        store = SeqStore.from_seqs(["ecoli_sim"], [genome])
        genome_box["index"] = (store, FMIndex.build(store.text))
        genome_box["seconds"] = time.perf_counter() - t0

    host = threading.Thread(target=make_genome)
    host.start()
    try:
        phase_build()
    finally:
        host.join()
    if "index" not in genome_box:
        raise RuntimeError("the config-1 FM index build failed")
    store, fm = genome_box["index"]
    log(f"[config-1] genome {GENOME_LEN} bp, FM index with q={fm.prefix_q} "
        f"built in {genome_box['seconds']:.1f} s")

    gather_entries = phase_gather(card)
    verify_entry = phase_verify(store.text, card)
    stacked_entry = phase_stacked_verify(card)

    t0 = time.perf_counter()
    full = simulate_reads(store, N_BATCHES * BATCH)
    batches = [sub_batch(full, np.arange(b0, b0 + BATCH))
               for b0 in range(0, N_BATCHES * BATCH, BATCH)]
    log(f"[config-1] simulated {N_BATCHES} x {BATCH} reads in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_chunk("config-1", store, fm, batches[0], READ_LEN, ERROR_RATE, card)
    by_path = {"config-1": phase_config1(store, fm, batches, card)}
    for K, c in phase_sharded(store, fm, batches[0], card).items():
        by_path[f"sharded-K{K}"] = c
    del full, batches

    by_path["config-2"] = phase_config2(card)
    by_path["rep-rich"], approx_entries = phase_rep_rich(card)
    by_path["config-5"], flat_ms, nd_launches = phase_config5(card)
    for nd, c in nd_launches.items():
        by_path[f"mesh-nd{nd}"] = c
    by_path["cli"], by_path["multihost-cli"] = phase_cli(card)
    by_path["entry"] = phase_entry(card)
    # `launches` is each entry's own path's count: the stacked verify the
    # config-5 flat stream's, the repeat-rich gather shapes that path's,
    # the others config-2's
    verify_entry["launches"] = by_path["config-2"]["banded_verify"]
    stacked_entry["launches"] = by_path["config-5"]["banded_verify_stacked"]
    for e in gather_entries:
        path = "rep-rich" if e["shape"].startswith("rep-rich") else "config-2"
        e["launches"] = by_path[path]["row_gather"]
    for e in approx_entries:
        e["launches"] = by_path["rep-rich"]["approx_search"]
    for e in (verify_entry, stacked_entry, *gather_entries, *approx_entries):
        key = e["name"]
        e["launches_by_path"] = {p: c[key] for p, c in by_path.items() if key in c}
    stacked_entry["flat_step_ms"] = flat_ms
    log(f"[done] smoke run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [verify_entry, stacked_entry, *gather_entries,
                                  *approx_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
