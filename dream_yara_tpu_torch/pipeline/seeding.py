"""Pigeonhole seed cutting (counterpart of dream_yara_tpu/pipeline/seeding.py).

A read with error budget E is cut into E+1 disjoint seeds of length
len // (E+1); seed s starts at s * slen. Error budgets use integer
arithmetic (rate in 1/10000ths), so host and device agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

RATE_DENOM = 10_000


def errors_for(lengths, rate_ppm: int):
    """Per-read error budget floor(len * rate), rate in 1/10000ths."""
    return (lengths * rate_ppm) // RATE_DENOM


def rate_to_ppm(error_rate: float) -> int:
    return int(round(error_rate * RATE_DENOM))


def max_errors_for_batch(max_len: int, error_rate: float) -> int:
    return int(np.floor(max_len * error_rate))


def make_seeds(lengths: torch.Tensor, n_rows: int, rate_ppm: int,
               max_errors: int):
    """Seed descriptors for all seq rows (fwd + rc).

    lengths: (n,) int32 — per logical read; row r's read is r % n.
    Returns (rows, starts, slens): (S,) int32 each, S = n_rows * (max_errors+1);
    slens == 0 marks seeds beyond a read's own budget."""
    n = lengths.shape[0]
    ns = max_errors + 1
    dev = lengths.device
    rows = torch.arange(n_rows, device=dev, dtype=torch.int32).repeat_interleave(ns)
    sidx = torch.arange(ns, device=dev, dtype=torch.int32).repeat(n_rows)
    l = lengths[(rows % n).long()].to(torch.int32)
    e = errors_for(l, rate_ppm).to(torch.int32)
    nseeds = e + 1
    slen = l // nseeds
    starts = sidx * slen
    slens = torch.where(sidx < nseeds, slen, 0)
    return rows, starts, slens
