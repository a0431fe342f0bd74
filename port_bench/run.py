"""The benchmark of dream_yara_tpu_torch, the PyTorch/CUDA port of the
DREAM-Yara mapper, on one NVIDIA GPU.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json once, from the root of a checkout, and
prints as the last line of standard output one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `checks`, each number compared beside its limit. The same
numbers close standard error. Without a CUDA card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dream_yara_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name, clocks and power limit (nvidia-smi), or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "clocks.mem,power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def metric_values(cell, rec: dict, traced: bool) -> dict:
    """The cell's metrics by name: end to end, or per layer when traced.
    A per-layer reader that finds nothing returns None and is left out."""
    from port_bench.core import spec

    out = {}
    if not traced:
        values = {"reads_per_s": rec["reads"] / rec["window_s"],
                  "peak_device_gib": rec["peak_bytes"] / 2**30,
                  "setup_s": rec["setup_s"]}
        for m in cell.end_to_end:       # a name's first part is its quantity
            out[m["name"]] = {"value": values[m["name"].split(".")[0]],
                              "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = spec.reader(cell.bench_dir, m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def decide(checks: dict, limits: dict):
    """(correct, {name: {value, limit}}): every number within its limit;
    a number without a limit fails. The counts of check.INFO are not
    compared."""
    from port_bench.core.check import INFO

    table = {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()
             if k not in INFO}
    ok = all(t["limit"] is not None and t["value"] <= t["limit"]
             for t in table.values())
    return ok, table


def result_line(cell, rec: dict, traced: bool, kind: str) -> dict:
    """The result object of a run's record; `checks` comes last."""
    correct, table = decide(rec["checks"], cell.limits)
    result = {
        "correct": correct,
        "attempted": rec["checks"]["sampled"],
        "failed": rec["checks"]["missing"] + rec["checks"]["invalid"],
        "metrics": metric_values(cell, rec, traced),
        "device": {"platform": "gpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": rec["peak_bytes"]},
    }
    if traced:
        t = rec["trace"]
        result["device"].update(busy_s=t.get("busy_s", 0.0),
                                window_s=t.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": t.get("device_ops", []),
                               "idle_gaps": t.get("idle_gaps", [])}
    result["checks"] = table
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        log("port_bench: no CUDA device; this benchmark runs on the card only")
        return 2
    try:
        import dream_yara_tpu_torch
    except ImportError as e:
        log(f"port_bench: the port is not in this checkout: {e}")
        return 2
    if not Path(dream_yara_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        log(f"port_bench: the port was imported from outside the checkout: "
            f"{dream_yara_tpu_torch.__file__}")
        return 2
    from port_bench.core import cell as cellmod
    from port_bench.core import spec

    cell = spec.load(a.workload, ROOT)
    if any(w.get("chips", 1) > torch.cuda.device_count()
           for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
           if w["name"] == a.workload):
        log("port_bench: the cell asks for more cards than are visible")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"[card] {card_line()}")
    log(f"[cell] {a.workload} seed {a.seed} window {a.seconds} s trace {a.trace}")
    rec = cellmod.run(cell, a.seed, a.seconds, bool(a.trace), device, T_START, log)
    after_window, after_check = rec["host_probe_s"]
    log(f"[host] probe after window {after_window} s, after check {after_check} s")
    bad = forbidden_modules()
    if bad:
        log(f"port_bench: JAX or the JAX package was loaded: {bad}")
        return 3
    result = result_line(cell, rec, bool(a.trace),
                         torch.cuda.get_device_name(device))
    table = result["checks"]
    log(f"[card] {card_line()}")
    for k, t in table.items():
        log(f"check {k} {t['value']} limit {t['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
