"""Bins the prefilter routes a read to ("routed read-bins" over
"classified reads"). None where no read was counted."""


def read(rec: dict):
    t = rec["timers"]
    n = t.get("classified reads", 0)
    if not n:
        return None
    return t.get("routed read-bins", 0) / n
