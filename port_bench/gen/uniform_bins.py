"""Database kind `uniform_bins`: `bins` genomes of `bin_len` bp, uniform
random A/C/G/T, one contig a bin (a binned collection of microbial
genomes; uniform DNA has no repeats, so no read re-seeds).

Parameters: bins, bin_len, contig_prefix.
"""

from __future__ import annotations

import numpy as np


def make(p: dict, rng: np.random.Generator):
    bins, n = int(p["bins"]), int(p["bin_len"])
    seqs = rng.integers(0, 4, (bins, n), dtype=np.int8)
    names = [f"{p['contig_prefix']}{b:04d}" for b in range(bins)]
    return names, list(seqs)
