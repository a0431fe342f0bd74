"""Read kind `se_reads`: single-end reads of `read_len` bp, `subs`
[lo, hi] substitutions each, every other read reverse-complemented. The
source bin is uniform over the bins, weighted by length (so uniform over
the genome), and the start uniform over the bin.

Parameters: read_len, batch, pool, subs.
"""

from __future__ import annotations

import numpy as np

from port_bench.gen._reads import cut, revcomp, substitute


def make(p: dict, rng: np.random.Generator, names: list[str],
         seqs: list[np.ndarray]) -> list[dict]:
    L, n = int(p["read_len"]), int(p["batch"])
    lens = np.array([len(s) for s in seqs])
    w = lens / lens.sum()
    batches = []
    for _ in range(int(p["pool"])):
        src = rng.choice(len(seqs), size=n, p=w)
        start = rng.integers(0, lens[src] - L + 1)
        reads = cut(seqs, src, start, L)
        substitute(rng, reads, *p["subs"])
        reads[1::2] = revcomp(reads[1::2])
        batches.append({"names": [f"r{i}" for i in range(n)], "reads": reads,
                        "paired": False})
    return batches
