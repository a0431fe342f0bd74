"""Runs of tiny cells on the CPU, through the port's plain editions, held
against the reference: a sound run comes out correct; a run with its
timed path broken underneath, and the control, come out not correct; a
cell added as new files runs without an edit to a file already there."""

from __future__ import annotations

import sys
import time

import numpy as np
import pytest
import torch

from port_bench import run as runmod
from port_bench.core import cell, check, spec
from port_bench.tests.conftest import files_digest

CPU = torch.device("cpu")


def _run(root, bench, workload, seconds=1.0, seed=2**31 + 77):
    c = spec.load(workload, root, bench)
    rec = cell.run(c, seed, seconds, False, CPU, time.perf_counter(),
                   lambda m: print(m, file=sys.stderr))
    return c, rec, runmod.decide(rec["checks"], c.limits)


@pytest.mark.parametrize("workload", ["tiny-meta.tiny-se", "tiny-rr.tiny-se",
                                      "tiny-rr.tiny-pe"])
def test_tiny_window_is_correct_and_needs_no_edit(tiny_tree, small_rep_groups,
                                                  workload):
    root, bench, before = tiny_tree
    c, rec, (ok, table) = _run(root, bench, workload)
    assert ok, table
    assert rec["reads"] > 0 and rec["window_s"] > 0 and rec["setup_s"] > 0
    assert rec["checks"]["sampled"] == c.traffic["sample"] * (
        2 if c.traffic["kind"] == "pe_reads" else 1)
    after = files_digest(bench)
    assert {k: after[k] for k in before} == before      # no file edited
    line = runmod.result_line(c, rec, False, "cpu")
    assert set(line["metrics"]) == {"reads_per_s", "peak_device_gib", "setup_s"}


def _drop_half(fn):
    """A finisher that leaves out the records of the second half of a batch."""
    def broken(index, batch, m, *a, **kw):
        sam = fn(index, batch, m, *a, **kw)
        lines = sam.split(b"\n")
        return b"\n".join(lines[: len(lines) // 2]) + b"\n"
    return broken


def _shift_answers(fn):
    """A verification that reports every match one base to the right."""
    def broken(*a, **kw):
        dist, beg, end = fn(*a, **kw)
        return dist, beg + 1, end + 1
    return broken


@pytest.mark.parametrize("fault", ["half_batch_left_out", "answer_altered"])
@pytest.mark.parametrize("workload", ["tiny-meta.tiny-se", "tiny-rr.tiny-pe"])
def test_a_broken_timed_path_is_not_correct(tiny_tree, small_rep_groups,
                                            monkeypatch, fault, workload):
    import dream_yara_tpu_torch.parallel.dream_mesh as dream_mesh
    import dream_yara_tpu_torch.pipeline.dis_mapper as dis_mapper
    import dream_yara_tpu_torch.pipeline.flat_step as flat_step
    import dream_yara_tpu_torch.pipeline.map_step as map_step

    if fault == "half_batch_left_out":
        for mod in (dis_mapper, dream_mesh):
            monkeypatch.setattr(mod, "_finish_batch", _drop_half(mod._finish_batch))
    else:
        for mod in (map_step, flat_step):
            monkeypatch.setattr(mod, "banded_verify", _shift_answers(mod.banded_verify))
    root, bench, _ = tiny_tree
    _, rec, (ok, table) = _run(root, bench, workload)
    assert not ok, table
    if fault == "half_batch_left_out":
        assert rec["checks"]["missing"] > 0
    else:
        assert rec["checks"]["invalid"] + rec["checks"]["set_miss"] > 0


@pytest.mark.parametrize("workload", ["tiny-meta.tiny-se", "tiny-rr.tiny-pe"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(tiny_tree, workload, seed):
    root, bench, _ = tiny_tree
    c = spec.load(workload, root, bench)
    names, seqs, pool, rng = cell.generate(c, seed)
    counts = check.control(c, names, seqs, pool, rng)
    ok, table = runmod.decide(counts, c.limits)
    assert not ok, table
    assert counts["best_miss"] > c.limits["best_miss"]


def test_the_reference_reads_the_same_answers_twice(tiny_tree):
    root, bench, _ = tiny_tree
    c = spec.load("tiny-rr.tiny-se", root, bench)
    names, seqs, pool, _ = cell.generate(c, 5)
    from port_bench.ref.mapper import Text

    text = Text.build(names, seqs)
    picks = check.draw(pool, 1000, np.random.default_rng(1))   # every read
    cap = check.seed_cap(c.config)
    a = check.answers(text, pool, picks, c.config["mapper"], 0.03, cap)
    b = check.answers(text, pool, picks, c.config["mapper"], 0.03, cap)
    assert [[(x.matches, x.capped) for x in batch] for batch in a] == \
        [[(x.matches, x.capped) for x in batch] for batch in b]
    # the repeat-rich database: some sampled reads are capped, most not
    capped = [x.capped for batch in a for x in batch]
    assert 0 < sum(capped) < len(capped) / 2


@pytest.mark.gpu
def test_a_tiny_cell_on_the_card(tiny_tree):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root, bench, _ = tiny_tree
    c = spec.load("tiny-meta.tiny-se", root, bench)
    rec = cell.run(c, 3, 2.0, True, torch.device("cuda", 0), time.perf_counter(),
                   lambda m: None)
    ok, table = runmod.decide(rec["checks"], c.limits)
    assert ok, table
    assert rec["peak_bytes"] > 0
