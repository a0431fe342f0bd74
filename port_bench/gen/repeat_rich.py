"""Database kind `repeat_rich`: one genome with human-like interspersed and
tandem repeats, N-runs and a GC share, cut into contiguous bins of equal
length, one contig a bin.

The genome follows the port's own `utils/simulate.py::repeat_rich_genome`
(copied here so that the yardstick stays fixed): one master element of
`alu_len` bp re-inserted at about `alu_coverage` of the genome with
`alu_divergence` substitutions a copy, one tandem array (unit 4-40 bp,
300-1,500 bp long) and one N-run (50-400 bp) per `locus_spacing` bp.

Parameters: length, bins, gc, alu_len, alu_coverage, alu_divergence,
locus_spacing, contig_prefix.
"""

from __future__ import annotations

import numpy as np


def gc_text(rng: np.random.Generator, length: int, gc: float) -> np.ndarray:
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=length, p=p).astype(np.int8)


def genome(rng: np.random.Generator, p: dict) -> np.ndarray:
    length, gc = int(p["length"]), float(p["gc"])
    alu_len = int(p["alu_len"])
    g = gc_text(rng, length, gc)
    master = gc_text(rng, alu_len, gc)
    n_copies = max(1, int(length * float(p["alu_coverage"])) // alu_len)
    starts = rng.integers(0, length - alu_len, n_copies)
    copies = np.broadcast_to(master, (n_copies, alu_len)).copy()
    mutate = rng.random((n_copies, alu_len)) < float(p["alu_divergence"])
    shift = rng.integers(1, 4, (n_copies, alu_len)).astype(np.int8)
    copies = np.where(mutate, (copies + shift) % 4, copies).astype(np.int8)
    for s, c in zip(starts, copies):          # later copies overwrite earlier
        g[s : s + alu_len] = c
    n_loci = max(1, length // int(p["locus_spacing"]))
    for _ in range(n_loci):
        u = int(rng.integers(4, 40))
        total = int(rng.integers(300, 1500))
        unit = gc_text(rng, u, gc)
        s = int(rng.integers(0, length - total))
        g[s : s + total] = np.tile(unit, total // u + 1)[:total]
    for _ in range(n_loci):
        run = int(rng.integers(50, 400))
        s = int(rng.integers(0, length - run))
        g[s : s + run] = 4
    return g


def make(p: dict, rng: np.random.Generator):
    """(contig names, sequences), one contig a bin."""
    g = genome(rng, p)
    bins = int(p["bins"])
    cut = len(g) // bins
    names = [f"{p['contig_prefix']}{b}" for b in range(bins)]
    return names, [g[b * cut : (b + 1) * cut].copy() for b in range(bins)]
