"""dream-yara-tpu-update-filter — dynamic bin update of the prefilter.

Analog of reference src/d_update_filter.cpp [U] (SURVEY.md §2.1/§3.4): for
the given bin ids, clear that bin's bit column in the deserialized filter and
re-insert k-mers from the replacement fastas; rewrite the filter file.
O(filter), not O(database). Pair with `dream-yara-tpu-indexer --bin-id` to
rebuild the bin's FM-index.
"""

from __future__ import annotations

import argparse

from .common import cli_guard as __cli_guard
import sys
import time
from pathlib import Path


@__cli_guard
def main(argv=None):
    p = argparse.ArgumentParser(
        prog="dream-yara-tpu-update-filter",
        description="Clear + re-insert bins in the DREAM prefilter.")
    p.add_argument("bins", nargs="+", help="replacement fastas (one per bin id)")
    p.add_argument("-b", "--bin-ids", type=int, nargs="+", required=True)
    p.add_argument("-o", "--output-dir", required=True, help="database directory")
    p.add_argument("-ft", "--filter-type", default="bloom",
                   choices=["bloom", "kmer_direct"])
    p.add_argument("-v", "--verbose", action="count", default=0)
    a = p.parse_args(argv)

    if len(a.bins) != len(a.bin_ids):
        sys.exit("error: need one replacement fasta per --bin-ids entry")

    from ..index.ibf import InterleavedBloomFilter
    from ..index.kdx import DirectKmerFilter
    from ..io.fasta import read_fasta

    db_dir = Path(a.output_dir)
    t0 = time.time()
    if a.filter_type == "bloom":
        path = db_dir / "db.filter"
        filt = InterleavedBloomFilter.load(path)
    else:
        path = db_dir / "db.kdx"
        filt = DirectKmerFilter.load(path)

    filt.clear_bins(a.bin_ids)
    for bin_id, fasta in zip(a.bin_ids, a.bins):
        _, seqs = read_fasta(fasta)
        for s in seqs:
            filt.add_kmers(s, bin_id)
        if a.verbose:
            print(f"[update-filter] bin {bin_id} refreshed", file=sys.stderr)
    filt.save(path)
    print(f"[update-filter] updated bins {a.bin_ids} in {time.time() - t0:.1f}s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
