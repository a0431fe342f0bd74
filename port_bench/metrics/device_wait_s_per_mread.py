"""Seconds the host waited on the card for a batch's matches (the timers
"device wait+fetch" of the bin mappers and "mesh fetch (device wait)" of
the flat step), per million reads in the window."""

from port_bench.metrics._timers import per_mread


def read(rec: dict):
    return per_mread(rec, ("device wait+fetch", "mesh fetch (device wait)"))
