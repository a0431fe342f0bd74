"""How full the repetitive re-seed groups run: real rows over the rows of
the groups, padding included ("repetitive rows" over "repetitive group
slots"), in %. None where no group ran."""


def read(rec: dict):
    t = rec["timers"]
    n = t.get("repetitive group slots", 0)
    if not n:
        return None
    return 100.0 * t.get("repetitive rows", 0) / n
