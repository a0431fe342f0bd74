"""The control of the comparison that decides `correct`: the plain
reference put in the program's place with one guarantee of the
configuration broken (it maps at an error budget one below the one the
configuration states), on a cell's own sample, for each seed. The
benchmark's runs never run it; its readings set the upper ends of the
limits in limits/<cell>.json.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from port_bench.core import cell as cellmod
    from port_bench.core import check, spec

    cell = spec.load(a.workload, ROOT)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        names, seqs, pool, r_sample = cellmod.generate(cell, seed)
        counts = check.control(cell, names, seqs, pool, r_sample)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": counts,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
