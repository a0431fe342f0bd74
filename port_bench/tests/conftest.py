"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's tree
with tiny cells added as new files, in the way a later change adds one."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIGS = {
    "tiny-rr": ("chr21-8bins", {"database": {"length": 400_000, "bins": 4},
                                "filter": {"size_bits": 1 << 22}}),
}
# the flat path (`--mesh`) over uniform random bins: no cell of
# BENCHMARK.json runs it yet, so its tiny configuration has no source file
TINY_META = {
    "name": "tiny-meta", "source": "a tiny flat-path database of the CPU tests",
    "database": {"kind": "uniform_bins", "bins": 8, "bin_len": 50_000,
                 "contig_prefix": "g"},
    "index": {"sample_rate": 1},
    "filter": {"kind": "bloom", "bits_per_bp": 12, "n_hashes": 3, "k": 19,
               "canonical": True, "blocked": True},
    "mapper": {"error_rate": 0.03, "secondary_matches": "tag"},
    "path": "mesh", "reduced": [],
}
TINY_TRAFFIC = {
    "tiny-pe": ("pe150", {"batch_pairs": 300, "pool": 2, "warmup": 1, "sample": 60}),
    "tiny-se": ("se100", {"batch": 500, "pool": 2, "warmup": 1, "sample": 80}),
}
# exact numbers at 0; the sampled counts of a few reads at fault in a
# sample of 60-120, which the tiny repeat-rich database can show
TINY_LIMITS = {"missing": 0, "invalid": 0, "sam_differs": 0, "best_miss": 2,
               "set_miss": 6, "mapq_miss": 6, "primary_miss": 6}
TINY_CELLS = {"tiny-rr.tiny-pe": ("tiny-rr", "tiny-pe"),
              "tiny-rr.tiny-se": ("tiny-rr", "tiny-se"),
              "tiny-meta.tiny-se": ("tiny-meta", "tiny-se")}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and k in base else v
    return out


def files_digest(tree: Path) -> dict:
    return {p.relative_to(tree).as_posix(): p.read_bytes()
            for p in sorted(tree.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture
def tiny_tree(tmp_path):
    """(root, bench dir, digest of the copied files before any new file):
    the benchmark copied under tmp_path, and tiny configurations, traffic,
    limits and cells added as new files."""
    bench = tmp_path / "port_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = files_digest(bench)
    for name, (src, over) in TINY_CONFIGS.items():
        cfg = _merge(json.loads((bench / "configs" / f"{src}.json").read_text()), over)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "configs" / "tiny-meta.json").write_text(json.dumps(TINY_META))
    for name, (src, over) in TINY_TRAFFIC.items():
        t = _merge(json.loads((bench / "traffic" / f"{src}.json").read_text()), over)
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(t))
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (c, t) in TINY_CELLS.items():
        bm["workloads"].append({"name": cell, "config": c, "traffic": t, "chips": 1,
                                "why": "a tiny cell of the CPU tests"})
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(TINY_LIMITS))
    # the tiny cells report what the cells of their source configuration
    # do; the flat path's, what the default path's do
    src = {cell: TINY_CONFIGS.get(c, ("chr21-8bins",))[0]
           for cell, (c, _) in TINY_CELLS.items()}
    for m in bm["end_to_end"] + bm["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [cell for cell, s in src.items()
                               if any(w.startswith(s + ".") for w in m["workloads"])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    return tmp_path, bench, before


@pytest.fixture
def small_rep_groups(monkeypatch):
    """Repetitive re-seed groups of 16 rows: at their real size a group
    takes tens of seconds on this CPU."""
    from dream_yara_tpu_torch.pipeline.mapper import BinMapper

    monkeypatch.setattr(BinMapper, "REP_PAD", 16)
