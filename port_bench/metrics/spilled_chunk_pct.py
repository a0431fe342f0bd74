"""Share of the bin mappers' map-step chunks whose compacted verify
spilled, so that the chunk was verified again dense ("spilled chunks"
over "map chunks"), in %. None where no chunk was counted."""


def read(rec: dict):
    t = rec["timers"]
    n = t.get("map chunks", 0)
    if not n:
        return None
    return 100.0 * t.get("spilled chunks", 0) / n
