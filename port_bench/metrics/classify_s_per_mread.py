"""Seconds of the prefilter (the timer "ibf classify": classify on the
card and the routing fetch), per million reads in the window."""

from port_bench.metrics._timers import per_mread


def read(rec: dict):
    return per_mread(rec, ("ibf classify",))
