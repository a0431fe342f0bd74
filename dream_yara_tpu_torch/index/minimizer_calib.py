"""Empirical (k,w)-correct minimizer routing-threshold calibration.

Minimizer winnowing (reference build_filter's optional mode,
src/d_build_filter.cpp [U,M]) cuts classify row gathers ~(w-k)/2-fold, but
the routing threshold must then bound how many SELECTED read minimizers e
substitution errors can fail to hit the filter. A closed-form bound is
either unsafe or hopelessly loose (the shipped 2D heuristic measured ~2x
too loose — BASELINE.md); the production approach (cf. Raptor's
probabilistic thresholds) is to Monte-Carlo the slack distribution with the
EXACT winnowing implementation and store a per-error-count table in the
filter artifact.

Semantics match the device counter exactly (round-4 advisor finding): the
classifier counts one hit per SELECTED WINDOW OCCURRENCE (duplicate keys
count each time they are selected), so for a read with selected occurrence
keys r_1..r_n and genome selected-key set G,

    device_count = |{i : r_i in G}|        (Bloom FPs only ADD counts)
    slack        = n - device_count

Genome-side selection is simulated with w bases of flanking context around
the fragment, because build-filter winnows the whole bin sequence: every
read window is a genome window, so genome-selected >= fragment-selected,
and the flanks close most of the remaining gap (what is left makes the
calibrated slack conservative in the safe direction — real counts >= the
simulated ones).

The stored table is slack_table[e] = q-quantile of slack over `trials`
random fragments, maximized over the calibration read lengths and forced
monotone in e. q defaults to 1e-3: a missed route costs one mate-rescue
sweep (or a lost multi-hit), not a wrong record, and FP routing is
controlled by filter sizing, not the threshold.
"""

from __future__ import annotations

import numpy as np

from .hashing import canonical_windows, kmer_windows, minimizer_select


def _selected_occurrences(codes: np.ndarray, k: int, w: int,
                          canonical: bool = True):
    """(keys, count): per-OCCURRENCE selected canonical minimizer keys."""
    win = canonical_windows if canonical else kmer_windows
    lo, hi, valid = win(codes, k)
    mask = minimizer_select(lo, hi, valid, w, k)
    return list(zip(lo[mask].tolist(), hi[mask].tolist())), int(mask.sum())


def device_slack_samples(rng, L: int, k: int, w: int, e: int, trials: int,
                         canonical: bool = True, pad: int | None = None
                         ) -> np.ndarray:
    """Distribution of n_minis - device_count over random fragments + e
    substitution errors, with device counting semantics (per occurrence)."""
    if pad is None:
        pad = w
    out = np.empty(trials, dtype=np.int64)
    for t in range(trials):
        ctx = rng.integers(0, 4, L + 2 * pad).astype(np.int8)
        g_keys = set(_selected_occurrences(ctx, k, w, canonical)[0])
        read = ctx[pad : pad + L].copy()
        if e:
            for p in rng.choice(L, size=e, replace=False):
                read[p] = (read[p] + int(rng.integers(1, 4))) % 4
        r_keys, n_minis = _selected_occurrences(read, k, w, canonical)
        device_count = sum(1 for key in r_keys if key in g_keys)
        out[t] = n_minis - device_count
    return out


def calibrate_slack_table(k: int, w: int, read_lens=(100, 150, 250),
                          e_max: int = 12, trials: int = 2000,
                          q: float = 1e-3, seed: int = 0,
                          canonical: bool = True) -> np.ndarray:
    """(e_max+1,) int32 slack table: max over read_lens of the (1-q)
    quantile per error count, forced monotone non-decreasing in e.

    e_max should cover the deployment's worst per-read error budget
    (len * error_rate); the classifier extrapolates past the end with the
    2D heuristic's per-error slack, so an undersized table degrades to
    conservative, never unsafe."""
    table = np.zeros(e_max + 1, dtype=np.int32)
    for L in read_lens:
        rng = np.random.default_rng(seed)
        for e in range(e_max + 1):
            if e == 0:
                continue  # error-free read windows are genome windows: 0
            s = device_slack_samples(rng, L, k, w, e, trials,
                                     canonical=canonical)
            table[e] = max(table[e],
                           int(np.quantile(s, 1.0 - q, method="higher")))
    return np.maximum.accumulate(table)
