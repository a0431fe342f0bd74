"""A fixed CPU workload, timed, to tell the host's speed apart from the
program's: the card's host can run the same Python up to a few times
slower for minutes at a time, and a host-paced rate follows it. The probe
uses no torch and no device; a run times it after the window and after
the check, outside `setup_s` and the window, and reports it on standard
error beside the rate. It is not a metric."""

from __future__ import annotations

import time

import numpy as np

LOOP_STEPS = 5_000_000
SORT_LEN = 1 << 22
SORT_SEED = 20_240_601


def probe() -> float:
    """Seconds of a 5,000,000-step pure-Python loop, then `np.sort` of a
    seeded 2^22-element float64 array (its generation untimed)."""
    a = np.random.default_rng(SORT_SEED).random(SORT_LEN)
    t0 = time.perf_counter()
    x = 0
    for i in range(LOOP_STEPS):
        x += i
    np.sort(a)
    return time.perf_counter() - t0
