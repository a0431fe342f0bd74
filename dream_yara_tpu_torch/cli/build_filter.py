"""dream-yara-tpu-build-filter — build the IBF / k-mer prefilter.

Analog of reference src/d_build_filter.cpp [U] (SURVEY.md §2.1/§3.3):
streams every bin fasta, inserts k-mers into the chosen filter, serializes
one filter file into the database dir.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from .common import cli_guard as __cli_guard,  expand_bin_paths, parse_size


@__cli_guard
def main(argv=None):
    p = argparse.ArgumentParser(
        prog="dream-yara-tpu-build-filter",
        description="Build the DREAM prefilter over all bins.")
    p.add_argument("bins", nargs="*", help="bin fasta files (bin order)")
    p.add_argument("--bins-dir", help="directory of bin fastas (sorted)")
    p.add_argument("-o", "--output-dir", required=True, help="database directory")
    p.add_argument("-ft", "--filter-type", default="bloom",
                   choices=["bloom", "kmer_direct", "none"])
    p.add_argument("-bs", "--bloom-size", default="64m",
                   help="filter size in BITS, e.g. 1g, 512m (bloom only)")
    p.add_argument("-k", "--kmer-size", type=int, default=19)
    p.add_argument("-nh", "--num-hashes", type=int, default=3)
    p.add_argument("-w", "--window-size", type=int, default=0,
                   help="minimizer window (> kmer-size enables winnowing: "
                        "~(w-k)/2x smaller filter load; routing threshold "
                        "becomes probabilistic — see docs)")
    p.add_argument("--calib-trials", type=int, default=2000,
                   help="Monte-Carlo trials per (length, error) cell for the "
                        "minimizer slack-table calibration stored in the "
                        "artifact (0 disables; minimizer mode only)")
    p.add_argument("--calib-emax", type=int, default=12,
                   help="largest per-read error count the calibrated "
                        "minimizer table covers (past it the classifier "
                        "extrapolates conservatively)")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-v", "--verbose", action="count", default=0)
    a = p.parse_args(argv)

    if a.filter_type == "none":
        print("[build-filter] filter-type none: nothing to build", file=sys.stderr)
        return


    from ..index.ibf import InterleavedBloomFilter
    from ..index.kdx import DirectKmerFilter
    from ..io.fasta import read_fasta

    paths = expand_bin_paths(a.bins, a.bins_dir)
    if not paths:
        p.error("no bin FASTA files given — pass them as positional "
                "arguments or point --bins-dir at a directory of them")
    t0 = time.time()
    if a.filter_type == "bloom":
        filt = InterleavedBloomFilter.create(
            bins=len(paths), size_bits=parse_size(a.bloom_size),
            n_hashes=a.num_hashes, k=a.kmer_size, window=a.window_size)
        out_name = "db.filter"
    else:
        filt = DirectKmerFilter.create(bins=len(paths), k=a.kmer_size)
        out_name = "db.kdx"

    def load_bin(b_fasta):
        b, fasta = b_fasta
        _, seqs = read_fasta(fasta)
        return b, seqs

    if a.threads > 1:
        # parallel fasta parse + k-mer hashing across bins (reference
        # OpenMP loop over bins, SURVEY.md §3.3); the shared-word scatter
        # itself stays sequential (bins in one 32-bin word share uint32s)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=a.threads) as ex:
            for b, seqs in ex.map(load_bin, enumerate(paths)):
                for s in seqs:
                    filt.add_kmers(s, b)
                if a.verbose:
                    print(f"[build-filter] bin {b}: {len(seqs)} contigs",
                          file=sys.stderr)
    else:
        for b, fasta in enumerate(paths):
            _, seqs = read_fasta(fasta)
            for s in seqs:
                filt.add_kmers(s, b)
            if a.verbose:
                print(f"[build-filter] bin {b}: {len(seqs)} contigs",
                      file=sys.stderr)

    if a.window_size > a.kmer_size and (a.filter_type != "bloom"
                                        or a.calib_trials <= 0):
        # without a calibrated table the routing threshold falls back to
        # the 2D heuristic, which collapses past ~1-2 errors per read and
        # routes every read to every bin (docs/OUTPUT_CONTRACT.md)
        print(f"[build-filter] WARNING: minimizer mode (-w {a.window_size}) "
              f"without slack-table calibration uses the loose 2D-heuristic "
              f"threshold, which collapses at >=2 errors per read and "
              f"degrades routing to every-bin; pass --calib-trials > 0 "
              f"(bloom only) or use -w 0", file=sys.stderr)
    if a.filter_type == "bloom" and a.window_size > a.kmer_size \
            and a.calib_trials > 0:
        # calibrate the minimizer routing slack with device counting
        # semantics and store the table in the artifact — the 2D closed-form
        # heuristic measured ~2x too loose (its threshold collapses past
        # ~2 errors and every read routes to every bin)
        tc = time.time()
        filt.calibrate(e_max=a.calib_emax, trials=a.calib_trials)
        print(f"[build-filter] minimizer slack table (e<=%d): %s "
              f"(%.1fs Monte-Carlo)" % (a.calib_emax,
                                        filt.slack_table.tolist(),
                                        time.time() - tc), file=sys.stderr)

    db_dir = Path(a.output_dir)
    db_dir.mkdir(parents=True, exist_ok=True)
    filt.save(db_dir / out_name)
    print(f"[build-filter] {a.filter_type} filter over {len(paths)} bins "
          f"({filt.words.nbytes >> 20} MiB) in {time.time() - t0:.1f}s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
