"""Repeat-rich synthetic genome + read simulation (VERDICT r2 weak #8).

Uniform-random DNA flatters an FM-index mapper: seed intervals stay tiny,
the classifier never re-seeds, verify lanes stay sparse. Real genomes are
repeat-rich — interspersed mobile-element families (ALu/LINE-like), tandem
arrays, assembly N-runs, and skewed GC. No real data is downloadable in
this environment (SURVEY.md §6), so this module synthesizes those
structures deterministically for tests and benches:

  * one master element per repeat family, re-inserted many times with
    per-copy divergence (substitutions) — the multi-mapping stressor;
  * tandem arrays (unit 2-50 bp, hundreds of copies) — seed-interval
    blowups and verify-budget spills;
  * N-runs — alphabet edge cases in packing/seeding/IBF hashing;
  * GC skew — non-uniform symbol statistics (occ-table imbalance).

Reference parallel: none (the reference repo tests on real fastas);
this replaces that coverage offline.
"""

from __future__ import annotations

import numpy as np


def gc_skewed_text(rng: np.random.Generator, length: int,
                   gc: float = 0.6) -> np.ndarray:
    """Random A/C/G/T codes with P(G)+P(C) = gc."""
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=length, p=p).astype(np.int8)


def _diverge(rng: np.random.Generator, seq: np.ndarray,
             divergence: float) -> np.ndarray:
    out = seq.copy()
    n_mut = rng.binomial(len(seq), divergence)
    pos = rng.choice(len(seq), size=n_mut, replace=False)
    out[pos] = (out[pos] + rng.integers(1, 4, size=n_mut)) % 4
    return out


def repeat_rich_genome(rng: np.random.Generator, length: int, *,
                       gc: float = 0.6,
                       alu_len: int = 300, alu_count: int | None = None,
                       alu_divergence: float = 0.12,
                       tandem_loci: int | None = None,
                       tandem_unit: tuple[int, int] = (4, 40),
                       tandem_total: tuple[int, int] = (300, 1500),
                       n_runs: int | None = None,
                       n_run_len: tuple[int, int] = (50, 400)
                       ) -> tuple[np.ndarray, dict]:
    """Genome with interspersed + tandem repeats, N-runs and GC skew.

    Densities default to human-like scale: ~10% of the genome covered by
    the interspersed family, one tandem locus and one N-run per ~100 kbp.
    Returns (codes int8, annotation dict with 'alu', 'tandem', 'nrun'
    half-open intervals) so tests can sample reads from known regions.
    """
    g = gc_skewed_text(rng, length, gc)
    ann: dict = {"alu": [], "tandem": [], "nrun": []}

    if alu_count is None:
        alu_count = max(1, length // (10 * alu_len))   # ~10% coverage
    master = gc_skewed_text(rng, alu_len, gc)
    for _ in range(alu_count):
        p = int(rng.integers(0, length - alu_len))
        g[p : p + alu_len] = _diverge(rng, master, alu_divergence)
        ann["alu"].append((p, p + alu_len))

    if tandem_loci is None:
        tandem_loci = max(1, length // 100_000)
    for _ in range(tandem_loci):
        u = int(rng.integers(*tandem_unit))
        total = int(rng.integers(*tandem_total))
        unit = gc_skewed_text(rng, u, gc)
        arr = np.tile(unit, total // u + 1)[:total]
        p = int(rng.integers(0, length - total))
        g[p : p + total] = arr
        ann["tandem"].append((p, p + total))

    if n_runs is None:
        n_runs = max(1, length // 100_000)
    for _ in range(n_runs):
        run = int(rng.integers(*n_run_len))
        p = int(rng.integers(0, length - run))
        g[p : p + run] = 4   # N
        ann["nrun"].append((p, p + run))
    return g, ann


def sample_reads(rng: np.random.Generator, genome: np.ndarray, n: int,
                 read_len: int = 100, n_sub: int = 2,
                 regions: list[tuple[int, int]] | None = None,
                 rc_half: bool = True):
    """Planted reads with <= n_sub substitutions, avoiding N-dominated
    windows (a real sampler rejects those too). With `regions`, half the
    reads start inside one of the given intervals (repeat stress)."""
    from .alphabet import revcomp

    reads, truth = [], []
    i = 0
    while len(reads) < n:
        i += 1
        if regions and len(reads) % 2 == 0:
            lo, hi = regions[int(rng.integers(0, len(regions)))]
            p = int(rng.integers(max(0, lo - read_len // 2),
                                 min(hi, len(genome) - read_len)))
        else:
            p = int(rng.integers(0, len(genome) - read_len))
        r = genome[p : p + read_len].copy()
        if (r == 4).sum() > read_len // 4:   # N-dominated: resample
            if i > 50 * n:
                raise RuntimeError("cannot sample enough N-free reads")
            continue
        k = int(rng.integers(0, n_sub + 1))
        for _ in range(k):
            j = int(rng.integers(0, read_len))
            if r[j] < 4:
                r[j] = (r[j] + int(rng.integers(1, 4))) % 4
        strand = int(rng.random() < 0.5) if rc_half else 0
        if strand:
            r = revcomp(r)
        reads.append(r)
        truth.append((p, strand, k))
    return reads, truth
