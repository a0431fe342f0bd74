"""Shared by the timer readers: seconds of program stages over the window,
per million reads mapped in it."""


def per_mread(rec: dict, stages) -> float:
    t = rec["timers"]
    return sum(t.get(s, 0.0) for s in stages) / rec["reads"] * 1e6
