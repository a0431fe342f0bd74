"""The command's contract: the result line's keys, no run without a card,
and no JAX anywhere in the benchmark."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import run as runmod
from port_bench.core import spec

BENCH = spec.BENCH_DIR
ROOT = BENCH.parent
OLD_BENCHES = (r"chip_smoke", r"(?<![\w/])bench\.py", r"BENCH_", r"MULTICHIP_",
               r"(?<![\w/])tools/")
TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _rec(traced):
    checks = {"missing": 0, "invalid": 0, "best_miss": 1, "set_miss": 2,
              "mapq_miss": 0, "primary_miss": 1, "sam_differs": 0, "sampled": 2000}
    trace = {"window_s": 8.0, "busy_s": 2.0, "device_ops": [["k", 1.0]],
             "idle_gaps": [["sam write (host)", 3.0]],
             "verify": {"launches": 2, "bound_s": 1e-5, "kernels": 2, "kernel_s": 1e-4},
             "gather": {"launches": 2, "bound_s": 1e-5, "kernels": 2, "kernel_s": 4e-5}}
    timers = {"device wait+fetch": 1.0, "ibf classify": 2.0,
              "repetitive re-seed (device)": 3.0, "mesh collect (host)": 1.0,
              "sam write (host)": 1.0}
    if traced:
        # the spans and counters that a traced run keeps
        timers.update({"device-timed reads": 4 * 10**5, "map step (device time)": 5.0,
                       "map chunks": 40, "spilled chunks": 40,
                       "repetitive stratum 1 (device time)": 1.0,
                       "repetitive stratum 2 (device time)": 0.5,
                       "repetitive seed search (device time)": 0.4,
                       "repetitive rows": 600, "repetitive group slots": 1024,
                       "repetitive rank rows": 20, "repetitive lockstep rows": 100,
                       "classified reads": 4 * 10**5, "routed read-bins": 5 * 10**5})
    return {"reads": 10**6, "window_s": 30.0, "setup_s": 50.0, "peak_bytes": 2**32,
            "checks": checks, "timers": timers, "trace": trace if traced else {}}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_result_line_has_the_contract_keys(workload, traced):
    c = spec.load(workload, ROOT)
    line = runmod.result_line(c, _rec(traced), traced, "NVIDIA H100 80GB HBM3")
    keys = list(line)
    assert keys[: len(TOP_KEYS)] == TOP_KEYS and keys[-1] == "checks"
    assert set(keys) == set(TOP_KEYS) | {"checks"} | ({"breakdown"} if traced else set())
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["device"]) == dev | ({"busy_s", "window_s"} if traced else set())
    want = c.per_layer if traced else c.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    json.dumps(line)
    if traced:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_number_without_a_limit_fails():
    ok, table = runmod.decide({"missing": 0, "new_number": 0}, {"missing": 0})
    assert not ok and table["new_number"]["limit"] is None


def test_a_run_without_a_card_fails(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = runmod.main(["--workload", "chr21-8bins.pe150", "--seed", "1",
                      "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_the_command_fails_in_a_tree_of_the_benchmark_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "chr21-8bins.pe150", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def _sources():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    tops = {name.split(".")[0] for name in _imported(tree)}
    assert not tops & set(runmod.FORBIDDEN), tops
    if "tests" in path.relative_to(BENCH).parts:
        return
    # nor names the old benchmarks or the smoke anywhere in its text
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for old in OLD_BENCHES:
                assert not re.search(old, node.value), (old, node.value)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dream_yara_tpu_torch_like", object())
    assert runmod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert runmod.forbidden_modules() == ["jax.numpy"]
