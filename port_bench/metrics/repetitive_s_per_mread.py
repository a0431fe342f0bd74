"""Seconds of the repetitive re-seed pass (the timer "repetitive re-seed
(device)", whose groups each end in a fetch), per million reads."""

from port_bench.metrics._timers import per_mread


def read(rec: dict):
    return per_mread(rec, ("repetitive re-seed (device)",))
