"""How much of the plain lockstep's rank-row fetches the repetitive
strata's seed search makes: "repetitive rank rows" (the rows it fetched)
over "repetitive lockstep rows" (2 x seeds x layouts x trips, every lane
at every trip), in %. None where no enum group ran, as on a program
without these counters."""


def read(rec: dict):
    t = rec["timers"]
    n = t.get("repetitive lockstep rows", 0)
    if not n:
        return None
    return 100.0 * t.get("repetitive rank rows", 0) / n
