"""How far a metric's runs spread, and the rules that choose the window and
the bounds of BENCHMARK.json from it. A set is the runs of one cell, on
one machine, at one window, one value a run.

    python3 port_bench/core/spread.py runs.jsonl

reads one JSON object a line, each a run's `cell`, `call`, `seconds` and
`metrics` (a name and its value), and prints the table of each set and
the window and bounds the rules give."""

from __future__ import annotations

import json
import math
import statistics
import sys
from collections import defaultdict

# a check of a later change calls a bound under twice the spread it reads
# too tight; about five times the quartile spread is the benchmark's rule;
# a bound lies within 0.01-0.25 and a window is at most 51 s
TIGHT = 2.0
QUARTILE_TIMES = 5.0
STEP = 0.05
LOWEST, HIGHEST = 0.01, 0.25
LONGEST_WINDOW = 51


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, the quartiles of `statistics.quantiles(n=4)`."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_range(values) -> float:
    """The range of the runs over their median, leaving out the run
    farthest from the median where that narrows it (one of two that tie)."""
    med = statistics.median(values)
    rest = sorted(values)
    if len(rest) > 2:
        rest.pop(0 if med - rest[0] > rest[-1] - med else -1)
    return (rest[-1] - rest[0]) / med


def median_gap(a, b) -> float:
    """How far the second set's median lies from the first's, as a share."""
    ma = statistics.median(a)
    return abs(statistics.median(b) - ma) / ma


def choose_window(widest: dict, longest: int = LONGEST_WINDOW) -> int:
    """The shortest window, or a longer one of at most `longest` seconds
    that narrows the widest trimmed range to two thirds or less of the
    shortest's. `widest` maps a window in seconds to that spread."""
    short = min(widest)
    fits = [s for s in widest if s <= longest and widest[s] <= 2 / 3 * widest[short]]
    return max(fits, default=short)


def bound(sets: list, lowest: float = LOWEST, highest: float = HIGHEST) -> dict:
    """The bound of one metric from its sets at the chosen window: twice
    the widest trimmed range (a check calls a bound under that too tight),
    five times the widest quartile spread, or the widest gap between two
    sets' medians of one cell, whichever is largest, rounded up to the
    next 0.05 and held within [lowest, highest]. `sets` is a list of
    (cell, values) pairs; two sets of one cell are compared for the gap."""
    w = max(trimmed_range(v) for _, v in sets)
    q = max(quartile_spread(v) for _, v in sets)
    by_cell = defaultdict(list)
    for c, v in sets:
        by_cell[c].append(v)
    g = max((median_gap(a, b) for vs in by_cell.values()
             for i, a in enumerate(vs) for b in vs[i + 1:]), default=0.0)
    want = max(TIGHT * w, QUARTILE_TIMES * q, g)
    rounded = math.ceil(round(want / STEP, 9)) * STEP
    return {"trimmed_range": w, "quartile_spread": q, "median_gap": g,
            "wanted": want, "bound": round(min(max(rounded, lowest), highest), 2),
            "held_at_highest": rounded > highest}


def table(runs: list) -> dict:
    """{(cell, call, seconds): {metric: [values in run order]}}; the host
    probe's readings, where a run has them, under "host_probe_s"."""
    out = defaultdict(lambda: defaultdict(list))
    for r in runs:
        key = (r["cell"], r["call"], r["seconds"])
        for m, v in r["metrics"].items():
            out[key][m].append(v)
        out[key]["host_probe_s"] += r.get("host_probe_s", [])
    return out


def main(path: str) -> None:
    with open(path) as f:
        runs = [json.loads(line) for line in f if line.strip()]
    sets = table(runs)
    rate = "reads_per_s"
    for (c, call, s), ms in sorted(sets.items()):
        for m, v in sorted(ms.items()):
            if m == "host_probe_s":
                if v:
                    print(f"{c} call {call} {s} s host probe {min(v)}-{max(v)} s")
                continue
            print(f"{c} call {call} {s} s {m}: n {len(v)} median "
                  f"{statistics.median(v)} quartile spread {quartile_spread(v)} "
                  f"trimmed range {trimmed_range(v)} min {min(v)} max {max(v)}")
    windows = sorted({s for (_, _, s) in sets})
    for (c, call) in sorted({(c, call) for (c, call, _) in sets}):
        if len(windows) > 1:
            a, b = (sets[(c, call, s)][rate] for s in windows[:2])
            print(f"{c} call {call}: {rate} median at {windows[1]} s against "
                  f"{windows[0]} s {median_gap(a, b)}")
    widest = {s: max(trimmed_range(ms[rate]) for (_, _, s2), ms in sets.items()
                     if s2 == s) for s in windows}
    window = choose_window(widest)
    print(f"widest trimmed range of {rate} by window {widest}; window {window}")
    print(f"{rate}:", bound([(c, ms[rate]) for (c, _, s), ms in sets.items()
                             if s == window]))
    print("setup_s:", bound([(c, ms["setup_s"]) for (c, _, _), ms in sets.items()],
                            lowest=0.25))


if __name__ == "__main__":
    main(sys.argv[1])
