"""dream-yara-tpu-indexer — build one FM-index per bin.

Analog of reference src/d_indexer.cpp [U] (SURVEY.md §2.1/§3.2): loops over
bin fastas, builds contig store + FM-index per bin, writes per-bin artifacts
<db>/bins/NNNN.{store,fm}.npz + <db>/meta.json. --bin-id rebuilds a single
bin in place without touching the others (the dynamic update path, config 4
in BASELINE.json — pair with dream-yara-tpu-update-filter).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

from .common import cli_guard as __cli_guard,  expand_bin_paths


def device_bytes_per_bp(sample_rate: int) -> float:
    """HBM bytes per text bp for one resident DeviceFM: text(1) + bwt(1)
    + occ(24/128) + fused rank rows(96/128) + SA (4 full / ~0.7 sampled@8)."""
    sa = 4.0 / sample_rate + (0.3 if sample_rate > 1 else 0.0)
    return 1 + 1 + 24 / 128 + 96 / 128 + sa


AUTO_RATES = (1, 8, 16, 32)


def auto_sample_rate(total_bp: int, hbm_gb: float) -> int:
    """Default SA sampling rate when -sr is not given (VERDICT r2 weak #6:
    a full-SA default produced artifacts the flagship config could not
    load). The mapper stacks EVERY bin's tables on one chip in the flat
    path, so the rule sizes the WHOLE database against half the chip's
    HBM (the other half holds the filter, read batches and activations):
    smallest rate whose device footprint fits, full SA for small DBs."""
    budget = hbm_gb * (1 << 30) * 0.5
    if total_bp <= 100 * 10**6:
        return 1
    for r in AUTO_RATES:
        if total_bp * device_bytes_per_bp(r) <= budget:
            return r
    return AUTO_RATES[-1]


def estimate_total_bp(paths) -> int:
    """Fast size estimate from file sizes (fasta ~1.01 bytes/bp; gz ~4x)."""
    total = 0
    for f in paths:
        sz = Path(f).stat().st_size
        total += sz * 4 if str(f).endswith(".gz") else sz
    return total


def check_hbm_ceiling(n_bp: int, sample_rate: int, hbm_gb: float, bin_id,
                      allow_oversize: bool = False):
    """A bin must fit one device's HBM (SURVEY.md §5.7). Refuse with
    actionable guidance instead of building an unusable artifact —
    unless the user opts into sharded big-bin mapping (--allow-oversize,
    parallel/sharded_fm.py splits every table over a mesh axis)."""
    need = n_bp * device_bytes_per_bp(sample_rate)
    budget = hbm_gb * (1 << 30) * 0.8  # leave 20% for activations
    if need > budget and allow_oversize and sample_rate != 1:
        sys.exit("error: --allow-oversize requires --sample-rate 1: the "
                 "sharded big-bin mapper (parallel/sharded_fm.py) shards "
                 "the FULL suffix array across devices instead of "
                 "sampling it")
    if need > budget and allow_oversize:
        print(f"[indexer] bin {bin_id}: ~{need / 2**30:.1f} GiB exceeds one "
              f"device's HBM; map it with ShardedBinMapper over "
              f">= {int(need / budget) + 1} devices", file=sys.stderr)
        return
    if need > budget:
        per_bp = device_bytes_per_bp(8)
        max_bp = int(budget / per_bp)
        sys.exit(
            f"error: bin {bin_id}: {n_bp} bp needs ~{need / 2**30:.1f} GiB "
            f"of device HBM (> {hbm_gb} GiB chip budget).\n"
            f"  Split this bin into pieces of at most ~{max_bp // 10**6} Mbp "
            f"(taxonomic splitting keeps the DREAM update property), or\n"
            f"  rebuild with --sample-rate 8 (sampled SA cuts the footprint "
            f"~2.8x at a small locate cost), or\n"
            f"  map it sharded over K devices "
            f"(parallel/sharded_fm.ShardedBinMapper splits every table over "
            f"a mesh axis; pass --allow-oversize here to build the artifact "
            f"anyway), or raise --hbm-gb if your chips have more memory.")


def build_one_bin(args):
    (fasta, db_dir, bin_id, sample_rate, hbm_gb, allow_oversize,
     tmp_dir, bidir) = args
    from ..index.fmindex import FMIndex
    from ..io.seqstore import SeqStore
    from .common import FASTA_EXTS  # noqa: F401
    from ..pipeline.dis_mapper import bin_file

    t0 = time.time()
    store = SeqStore.from_fasta(fasta)
    check_hbm_ceiling(len(store.text), sample_rate, hbm_gb, bin_id,
                      allow_oversize)
    fm = FMIndex.build(store.text, sample_rate=sample_rate,
                       tmp_dir=tmp_dir)
    (Path(db_dir) / "bins").mkdir(parents=True, exist_ok=True)
    store.save(bin_file(db_dir, bin_id, "store"))
    fm.save(bin_file(db_dir, bin_id, "fm"))
    if bidir:
        # reverse-text rank rows sidecar (index/bifm.py): enables the
        # bidirectional search-scheme seed backend in the mapper
        from ..index.bifm import build_reverse_fused

        rfused, rcounts = build_reverse_fused(store.text, tmp_dir=tmp_dir)
        import numpy as _np
        _np.savez(bin_file(db_dir, bin_id, "rfm"), rfused=rfused,
                  rcounts=rcounts)
    else:
        # a rebuilt bin must not leave a STALE reverse sidecar behind
        bin_file(db_dir, bin_id, "rfm").unlink(missing_ok=True)
    return bin_id, fm.n, time.time() - t0


@__cli_guard
def main(argv=None):
    p = argparse.ArgumentParser(
        prog="dream-yara-tpu-indexer",
        description="Build per-bin FM-indices for the DREAM database.")
    p.add_argument("bins", nargs="*", help="bin fasta files (bin order)")
    p.add_argument("--bins-dir", help="directory of bin fastas (sorted)")
    p.add_argument("-o", "--output-dir", required=True, help="database directory")
    p.add_argument("--sample-rate", type=int, default=None,
                   help="SA sampling rate (1 = full SA). Default: auto — "
                        "smallest of (1, 8, 16, 32) whose whole-database "
                        "device footprint fits half of --hbm-gb; --bin-id "
                        "rebuilds inherit the database's existing rate")
    p.add_argument("--hbm-gb", type=float, default=16.0,
                   help="per-chip HBM budget used to refuse bins that could "
                        "never be device-resident (v5e: 16)")
    p.add_argument("--allow-oversize", action="store_true",
                   help="build bins larger than one device's HBM anyway "
                        "(map them sharded: parallel/sharded_fm.py)")
    p.add_argument("--tmp-dir", default=None,
                   help="external-memory SA construction: back the suffix-array\n"
                        "work buffer with an OS-paged file in this directory\n"
                        "(reference indexer --tmp-dir analog)")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="parallel bin builds (processes)")
    p.add_argument("--bin-id", type=int, default=None,
                   help="rebuild ONLY this bin id from the single given fasta")
    p.add_argument("--bidir", action="store_true",
                   help="also build the reverse-text rank rows per bin "
                        "(bidirectional FM-index, SeqAn-style): the mapper "
                        "then uses search-scheme approximate seeding")
    p.add_argument("-v", "--verbose", action="count", default=0)
    a = p.parse_args(argv)

    db_dir = Path(a.output_dir)
    db_dir.mkdir(parents=True, exist_ok=True)

    if a.bin_id is not None:
        paths = expand_bin_paths(a.bins, a.bins_dir)
        if len(paths) != 1:
            sys.exit("error: --bin-id expects exactly one replacement fasta")
        rate = a.sample_rate
        if rate is None:
            # single-bin rebuild must keep the DB's locate semantics: take
            # the rate the database was built with, not a fresh auto choice
            meta_path = db_dir / "meta.json"
            rate = (json.loads(meta_path.read_text()).get("sample_rate", 1)
                    if meta_path.exists() else 1)
        if not a.bidir:
            # inherit bidir-ness: a bidir database's rebuilt bin keeps its
            # reverse sidecar in sync (like sample_rate above)
            from ..pipeline.dis_mapper import bin_file as _bf
            a.bidir = _bf(db_dir, a.bin_id, "rfm").exists()
        bin_id, n, dt = build_one_bin(
            (paths[0], db_dir, a.bin_id, rate, a.hbm_gb,
             a.allow_oversize, a.tmp_dir, a.bidir))
        print(f"[indexer] rebuilt bin {bin_id} ({n} bp, sample-rate {rate}) "
              f"in {dt:.1f}s", file=sys.stderr)
        return

    paths = expand_bin_paths(a.bins, a.bins_dir)
    rate = a.sample_rate
    if rate is None:
        rate = auto_sample_rate(estimate_total_bp(paths), a.hbm_gb)
        if rate > 1:
            print(f"[indexer] auto sample-rate {rate} "
                  f"(~{estimate_total_bp(paths) / 10**9:.2f} Gbp database "
                  f"vs {a.hbm_gb} GiB HBM; override with --sample-rate)",
                  file=sys.stderr)
    a.sample_rate = rate
    jobs = [(f, db_dir, b, rate, a.hbm_gb, a.allow_oversize,
             a.tmp_dir, a.bidir)
            for b, f in enumerate(paths)]
    t0 = time.time()
    if a.threads > 1:
        with ProcessPoolExecutor(max_workers=a.threads) as ex:
            results = list(ex.map(build_one_bin, jobs))
    else:
        results = [build_one_bin(j) for j in jobs]
    meta = {"n_bins": len(paths), "sample_rate": a.sample_rate,
            "bin_files": [str(f) for f in paths]}
    (db_dir / "meta.json").write_text(json.dumps(meta, indent=1))
    total = sum(n for _, n, _ in results)
    print(f"[indexer] {len(paths)} bins, {total} bp total, "
          f"{time.time() - t0:.1f}s wall", file=sys.stderr)


if __name__ == "__main__":
    main()
