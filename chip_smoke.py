#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dream_yara_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's config-1 single-end path once, at full size, and fails
(non-zero exit, no result line) on any error, when no CUDA device is
present, or when the port cannot be imported. Phases:

  1. card   — the card's name and power limit (nvidia-smi);
  2. build  — nvcc builds the banded-verify kernel from csrc/ (ptxas lines);
  3. kernel — the kernel against its plain PyTorch edition, exact equality,
              at the config-1 verify shape, at L=250/E=12 and on edge lanes,
              with both times from CUDA events;
  4. chunk  — one 8,192-read chunk through the map step on the CPU and on
              the card: the bundles must be identical;
  5. slice  — a 4.6 Mbp genome (seed 12345) and 4 x 65,536 simulated 100 bp
              reads (bench.py's workload) streamed through dream_map_stream;
              a 256-read subsample is checked against the golden model;
  6. result — the kernel table and the device line as JSON.

Every number printed is measured in this run, on the card named beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

GENOME_LEN = 4_600_000
READ_LEN = 100
ERROR_RATE = 0.03
BATCH = 65_536
N_BATCHES = 4
CHUNK_READS = 8_192
GOLDEN_READS = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def verify_case(rng, text: np.ndarray, C: int, L: int, E: int):
    """Candidates for banded verification, vectorised: reads cut from the
    text at their anchor shifted by up to E (indel-like offsets), with
    substitutions, some N, some shorter reads and some random reads; read
    rows are a permutation of the lanes. Returns numpy arrays
    (anchors, reads, read_rows, lengths)."""
    n = len(text)
    anchors = rng.integers(0, n - L - E, C).astype(np.int32)
    shift = rng.integers(-E, E + 1, C)
    pos = np.clip(anchors[:, None] + shift[:, None] + np.arange(L)[None, :],
                  0, n - 1)
    reads = text[pos].copy()
    sub = rng.random((C, L)) < 0.02
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    reads[rng.random((C, L)) < 0.002] = 4
    noise = rng.random(C) < 0.05
    reads[noise] = rng.integers(0, 4, (int(noise.sum()), L))
    lengths = np.full(C, L, np.int32)
    short = rng.random(C) < 0.1
    lengths[short] = rng.integers(1, L + 1, int(short.sum()))
    reads[np.arange(L)[None, :] >= lengths[:, None]] = 4
    perm = rng.permutation(C).astype(np.int32)
    return anchors, reads[perm].astype(np.int8), np.argsort(perm).astype(np.int32), lengths


def edge_case(text: np.ndarray, anchors, reads, read_rows, lengths):
    """Anchors at 0, near and past the text end and negative; length-0 lanes."""
    n = len(text)
    anchors[:8] = [0, 1, n - 10, n - 1, n + 5, -1, -3, -40]
    lengths[8:12] = 0
    read_rows[12] = reads.shape[0] + 7           # outside the read matrix
    return anchors, reads, read_rows, lengths


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def simulate_reads(store, n_reads: int):
    """bench.py's read simulator: 100 bp windows with 0-3 substitutions,
    every other read reverse-complemented (seed 999)."""
    from dream_yara_tpu_torch._shared import ReadBatch, revcomp

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


def sub_batch(batch, ids):
    from dream_yara_tpu_torch._shared import ReadBatch

    n = batch.n_reads
    return ReadBatch(names=[batch.names[i] for i in ids],
                     seqs=batch.seqs[np.concatenate([ids, n + ids])],
                     lengths=batch.lengths[ids],
                     quals=[batch.quals[i] for i in ids], paired=False)


def phase_kernel(text_np, card):
    """Kernel against plain edition; returns the kernel-table entry."""
    import torch

    from dream_yara_tpu_torch.ops import verify
    from dream_yara_tpu_torch.ops.banded_verify_cuda import kernel

    dev = torch.device("cuda")
    text = torch.from_numpy(text_np).to(dev)
    rng = np.random.default_rng(7)
    worst = 0
    timing = None
    for C, L, E, edges in ((131_072, 100, 3, False), (8_192, 250, 12, False),
                           (4_096, 100, 3, True), (4_096, 250, 12, True),
                           (2_048, 120, 31, True), (2_048, 60, 0, True)):
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
        log(f"[kernel] C={C} L={L} E={E} edges={edges}: max |kernel - plain| "
            f"dist/begin/end = {errs} (tolerance: exact, integer outputs); "
            f"lanes within E: {ok_lanes}/{C}")
        if any(errs):
            raise AssertionError(f"kernel disagrees with the plain edition at "
                                 f"C={C} L={L} E={E}: {errs}")
        if (C, L, E) == (131_072, 100, 3):
            args = (text, anchors, reads, rows, lengths, E)
            # in turns: plain, kernel, kernel, plain
            plain_ms = cuda_time_ms(lambda: verify.banded_verify(*args), 3)
            ms = cuda_time_ms(lambda: kernel(*args), 20)
            ms2 = cuda_time_ms(lambda: kernel(*args), 20)
            plain_ms2 = cuda_time_ms(lambda: verify.banded_verify(*args), 3)
            timing = (ms, plain_ms, ms2, plain_ms2)
        if (C, L, E) == (8_192, 250, 12):
            args = (text, anchors, reads, rows, lengths, E)
            log(f"[kernel] C=8192 L=250 E=12: kernel "
                f"{cuda_time_ms(lambda: kernel(*args), 20)} ms, plain "
                f"{cuda_time_ms(lambda: verify.banded_verify(*args), 3)} ms ({card})")
    ms, plain_ms, ms2, plain_ms2 = timing
    log(f"[kernel] C=131072 L=100 E=3 (config-1 verify lanes): kernel {ms} ms "
        f"then {ms2} ms, plain {plain_ms} ms then {plain_ms2} ms ({card})")
    return {"name": "banded_verify", "route": "cuda",
            "source": "dream_yara_tpu_torch/csrc/banded_verify.cu",
            "replaces": "dream_yara_tpu/ops/pallas_verify.py:30",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_chunk(store, fm, batch, card):
    """One 8,192-read chunk through the map step on the CPU and on the card."""
    import warnings

    import torch

    from dream_yara_tpu_torch.ops.device_index import DeviceFM, to_device
    from dream_yara_tpu_torch.ops.readpack import pack_blob_with_lengths
    from dream_yara_tpu_torch.pipeline.map_step import (
        max_seed_len_static, single_bin_map_step_packed, uniform_len_ok)

    half = CHUNK_READS
    ids = np.arange(half)
    L = READ_LEN
    rate_ppm, max_err = 300, 3
    lens = batch.lengths[ids].astype(np.int32)
    blob = pack_blob_with_lengths(batch.seqs[ids], lens, half, L).view(np.int32)
    kw = dict(half=half, L=L, rate_ppm=rate_ppm, max_errors=max_err, capacity=8,
              max_slen=max_seed_len_static(L, rate_ppm), prefix_q=fm.prefix_q,
              compact_cap=2 * half,
              uniform_len=uniform_len_ok(lens, L, rate_ppm, max_err))
    outs = {}
    for name in ("cpu", "cuda"):
        dev = torch.device(name)
        dfm = DeviceFM.from_host(fm, store.text, dev)
        blob_d = to_device(blob, dev)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if name == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("warn")
            try:
                out = single_bin_map_step_packed(dfm, blob_d, **kw)
            finally:
                if name == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        outs[name] = [x.cpu().numpy() for x in out]
        dt = time.perf_counter() - t0
        log(f"[chunk] {name}: map step on {half} reads in {dt:.3f} s (host clock, "
            f"incl. fetch); host syncs flagged inside the step: {len(syncs)}")
        for w in syncs[:5]:
            log(f"[chunk]   sync: {w.message}")
        if syncs:
            raise AssertionError("the map step synchronised with the host")
    for k, (a, b) in enumerate(zip(outs["cpu"], outs["cuda"])):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"chunk output {k} differs between CPU and CUDA")
    log(f"[chunk] CPU and CUDA bundles identical ({len(outs['cpu'][0])} words; "
        f"seed arrays {outs['cpu'][1].shape})")

    # the config-1 chunk: 65,536 reads = 131,072 rows, timed on the card
    half = BATCH
    ids = np.arange(half)
    lens = batch.lengths[ids].astype(np.int32)
    blob = pack_blob_with_lengths(batch.seqs[ids], lens, half, L).view(np.int32)
    dev = torch.device("cuda")
    dfm = DeviceFM.from_host(fm, store.text, dev)
    blob_d = to_device(blob, dev)
    kw.update(half=half, compact_cap=2 * half)
    ms = cuda_time_ms(lambda: single_bin_map_step_packed(dfm, blob_d, **kw), 3)
    log(f"[chunk] config-1 chunk ({half} reads, {2 * half} rows) map step: "
        f"{ms} ms on the card ({card})")


def phase_slice(store, fm, batches, card):
    import torch

    from dream_yara_tpu_torch._shared import (MapperOptions, StageTimers,
                                              golden_map_se)
    from dream_yara_tpu_torch.ops.banded_verify_cuda import kernel
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
    log(f"[slice] warm-up batch (index upload + first batch): "
        f"{time.perf_counter() - t0:.3f} s")

    n_total = sum(b.n_reads for b in batches)
    timers = StageTimers()
    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    t0 = time.perf_counter()
    sams = list(dream_map_stream(index, iter(batches), opts, timers=timers,
                                 stats=stats))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    n_records = sum(sum(1 for line in s.split(b"\n") if line and line[:1] != b"@")
                    for s in sams)
    log(f"[slice] {n_total} reads in {wall:.3f} s = {n_total / wall:.1f} reads/s "
        f"({card}); SAM records {n_records}; mapped {stats['mapped']}, "
        f"unique {stats['unique']}")
    log(f"[slice] peak device memory {peak} bytes ({peak / 2**20:.1f} MiB) ({card})")
    log(f"[slice] stage timers ({card}):\n{timers.report()}")
    log(f"[slice] banded-verify kernel launches in the stream: {launches}")
    if n_records < n_total:
        raise AssertionError(f"{n_records} SAM records for {n_total} reads")
    if launches == 0:
        raise AssertionError("the stream never launched the verify kernel")
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
    log(f"[slice] golden model agrees on {GOLDEN_READS} reads (matches, c1, c2), "
        f"and the stream's records for them are identical")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from dream_yara_tpu_torch._shared import FMIndex, SeqStore
    from dream_yara_tpu_torch.ops.banded_verify_cuda import kernel

    card = card_line()
    log(card)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    path = kernel.build()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in kernel.build_log.splitlines():
        log(f"[build] {line.strip()}")

    t0 = time.perf_counter()
    genome = np.random.default_rng(12345).integers(0, 4, GENOME_LEN).astype(np.int8)
    store = SeqStore.from_seqs(["ecoli_sim"], [genome])
    fm = FMIndex.build(store.text)
    log(f"[slice] genome {GENOME_LEN} bp, FM index with q={fm.prefix_q} built "
        f"in {time.perf_counter() - t0:.1f} s")

    entry = phase_kernel(store.text, card)

    t0 = time.perf_counter()
    full = simulate_reads(store, N_BATCHES * BATCH)
    batches = [sub_batch(full, np.arange(b0, b0 + BATCH))
               for b0 in range(0, N_BATCHES * BATCH, BATCH)]
    log(f"[slice] simulated {N_BATCHES} x {BATCH} reads in "
        f"{time.perf_counter() - t0:.1f} s")

    phase_chunk(store, fm, batches[0], card)
    entry["launches"] = phase_slice(store, fm, batches, card)

    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
