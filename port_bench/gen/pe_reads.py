"""Read kind `pe_reads`: FR pairs of `read_len` bp mates. A pair's bin is
uniform over the bins (weighted by length), its insert uniform in
`insert` [lo, hi], its start uniform over the bin; mate 1 is the forward
window at the start, mate 2 the reverse complement of the window that
ends the insert; each mate gets `subs` [lo, hi] substitutions.

Parameters: read_len, batch_pairs, pool, insert, subs.
"""

from __future__ import annotations

import numpy as np

from port_bench.gen._reads import cut, revcomp, substitute


def make(p: dict, rng: np.random.Generator, names: list[str],
         seqs: list[np.ndarray]) -> list[dict]:
    L, h = int(p["read_len"]), int(p["batch_pairs"])
    lo, hi = p["insert"]
    lens = np.array([len(s) for s in seqs])
    w = lens / lens.sum()
    batches = []
    for _ in range(int(p["pool"])):
        src = rng.choice(len(seqs), size=h, p=w)
        tlen = rng.integers(lo, hi + 1, h)
        start = rng.integers(0, lens[src] - hi + 1)
        m1 = cut(seqs, src, start, L)
        m2 = revcomp(cut(seqs, src, start + tlen - L, L))
        substitute(rng, m1, *p["subs"])
        substitute(rng, m2, *p["subs"])
        batches.append({"names": [f"p{i}" for i in range(h)] * 2,
                        "reads": np.concatenate([m1, m2]), "paired": True})
    return batches
