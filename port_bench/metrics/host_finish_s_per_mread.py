"""Seconds of host finishing (the timers "rank/dedup (host)", "cigar
(host)", "select pairs (host)" and "sam write (host)"), per million reads
in the window. The finisher threads overlap, so this can exceed the
window's share."""

from port_bench.metrics._timers import per_mread


def read(rec: dict):
    return per_mread(rec, ("rank/dedup (host)", "cigar (host)",
                           "select pairs (host)", "sam write (host)"))
