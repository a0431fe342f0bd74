"""The generators: deterministic from the seed, with the stated shapes."""

from __future__ import annotations

import json

import numpy as np
import pytest

from port_bench.core import cell, spec


@pytest.mark.parametrize("workload", ["tiny-rr.tiny-pe", "tiny-rr.tiny-se",
                                      "tiny-meta.tiny-se"])
def test_generation_is_deterministic_and_shaped(tiny_tree, workload):
    root, bench, _ = tiny_tree
    c = spec.load(workload, root, bench)
    seed = 2**31 + 12345                       # larger than 32 signed bits hold
    a = cell.generate(c, seed)
    b = cell.generate(c, seed)
    other = cell.generate(c, seed + 1)
    names, seqs, pool, _ = a
    db = c.config["database"]
    assert len(names) == len(seqs) == db["bins"]
    assert all(s.dtype == np.int8 for s in seqs)
    assert all(np.array_equal(x, y) for x, y in zip(seqs, b[1]))
    assert not all(np.array_equal(x, y) for x, y in zip(seqs, other[1]))
    t = c.traffic
    assert len(pool) == t["pool"]
    for e, f in zip(pool, b[2]):
        assert np.array_equal(e["reads"], f["reads"]) and e["names"] == f["names"]
        L = t["read_len"]
        if e["paired"]:
            assert e["reads"].shape == (2 * t["batch_pairs"], L)
            assert e["names"][: t["batch_pairs"]] == e["names"][t["batch_pairs"]:]
        else:
            assert e["reads"].shape == (t["batch"], L)
        assert e["reads"].min() >= 0 and e["reads"].max() <= 4


def test_repeat_rich_database_has_its_repeats(tiny_tree):
    root, bench, _ = tiny_tree
    c = spec.load("tiny-rr.tiny-pe", root, bench)
    names, seqs, _, _ = cell.generate(c, 7)
    g = np.concatenate(seqs)
    assert 0 < (g == 4).mean() < 0.02             # N-runs, a few per 100 kbp
    acgt = g[g < 4]
    gc = np.isin(acgt, (1, 2)).mean()
    assert abs(gc - c.config["database"]["gc"]) < 0.03
    # the interspersed family: a 25-mer of one copy recurs elsewhere
    from port_bench.ref import seeds
    q = np.stack([g[p : p + 25] for p in range(0, len(g) - 25, 997)])
    q = q[(q < 4).all(1)]
    qi, _ = seeds.occurrences(g, q)
    assert (np.bincount(qi, minlength=len(q)) > 1).any()


def test_traffic_files_name_their_generator(tiny_tree):
    _, bench, _ = tiny_tree
    for f in (bench / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        assert (bench / "gen" / f"{t['kind']}.py").exists()
        assert t["warmup"] >= 1 and t["pool"] >= 1 and t["sample"] > 0
