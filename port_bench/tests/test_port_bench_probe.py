"""The host probe: a fixed CPU workload that a run times after its window
and after its check, outside set-up and the window, with no device."""

from __future__ import annotations

import ast
import math
import subprocess
import sys
import time

import torch

from port_bench.core import cell, host_probe, spec
from port_bench.tests.conftest import ROOT


def test_probe_takes_seconds_and_no_device():
    s = host_probe.probe()
    assert math.isfinite(s) and s > 0
    assert not torch.cuda.is_initialized()
    tree = ast.parse(open(host_probe.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "torch" not in names
    out = subprocess.run([sys.executable, "-c",
                          "import sys; from port_bench.core import host_probe; "
                          "host_probe.probe(); print('torch' in sys.modules)"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr


def test_a_run_times_the_probe_twice_outside_setup_and_window(
        tiny_tree, small_rep_groups, monkeypatch):
    calls = []
    real = host_probe.probe

    def timed():
        calls.append(time.perf_counter())
        return real()

    monkeypatch.setattr(host_probe, "probe", timed)
    root, bench, _ = tiny_tree
    c = spec.load("tiny-rr.tiny-se", root, bench)
    t_start = time.perf_counter()
    rec = cell.run(c, 2**31 + 5, 1.0, False, torch.device("cpu"), t_start,
                   lambda m: None)
    probe_s = rec["host_probe_s"]
    assert len(probe_s) == 2 and all(math.isfinite(s) and s > 0 for s in probe_s)
    assert len(calls) == 2
    # both probes start after the window closed, so neither set-up nor the
    # window holds their time
    window_end = t_start + rec["setup_s"] + rec["window_s"]
    assert min(calls) > window_end
    assert calls[1] - calls[0] >= probe_s[0]
