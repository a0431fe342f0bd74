"""Find a cell's files by the names in BENCHMARK.json: its configuration
(configs/<config>.json), its traffic (traffic/<traffic>.json), its limits
(limits/<cell>.json), the generator kinds (gen/<kind>.py), the path
(paths/<path>.py) and the per-layer metric readers (metrics/<name>.py).
Nothing here knows a cell by name."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path


def load_module(path: Path, name: str):
    """Import one file of the benchmark under a name of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def kind(bench_dir: Path, folder: str, name: str):
    return load_module(bench_dir / folder / f"{name}.py",
                       f"port_bench.{folder}."
                       + name.replace("-", "_").replace(".", "__"))


def reader(bench_dir: Path, metric: str):
    """The reader of a per-layer metric: metrics/<name>.py, or for a name
    with a suffix (`host_finish_s_per_mread.mesh`, the same quantity in
    other cells) the reader of the part before the first dot."""
    name = metric if (bench_dir / "metrics" / f"{metric}.py").exists() \
        else metric.split(".")[0]
    return kind(bench_dir, "metrics", name)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: Path, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `workload` of root/BENCHMARK.json, its files under bench_dir."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = bench_dir / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    return Cell(workload, config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)],
                bench_dir)
