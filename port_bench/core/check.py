"""The comparison that decides `correct`: a sample of the window's reads,
drawn from the seed, judged against the plain reference (port_bench/ref/).
The reference is given the generated sequences and reads only."""

from __future__ import annotations

import numpy as np

from port_bench.ref import judge
from port_bench.ref.mapper import Text, pe_answers, se_answers


def draw(pool: list[dict], n_sample: int, rng: np.random.Generator):
    """Per pool batch, the sampled read (or pair) indices, sorted."""
    P = len(pool)
    out = []
    for i, e in enumerate(pool):
        n = len(e["reads"]) // (2 if e["paired"] else 1)
        k = min(n, n_sample // P + (i < n_sample % P))
        out.append(np.sort(rng.choice(n, k, replace=False)))
    return out


def seed_cap(cfg: dict) -> int | None:
    """The hits a seed that the configuration's mapper keeps in a bin:
    `hits_per_seed` at sensitivity high or low; None (every hit) at full."""
    if cfg["mapper"].get("sensitivity", "high") == "full":
        return None
    return cfg.get("hits_per_seed")


def answers(text: Text, pool, picks, mapper: dict, error_rate: float,
            cap: int | None = None):
    """The reference's answers of the sampled reads, per pool batch:
    [answers] (single-end) or [(answers of mates 1, of mates 2)]. All
    batches are mapped in one call, so the text is scanned once."""
    sizes = [len(ids) for ids in picks]
    cuts = np.cumsum([0] + sizes)
    strata = mapper.get("strata_count", 0)
    if pool[0]["paired"]:
        m1 = np.concatenate([e["reads"][ids] for e, ids in zip(pool, picks)])
        m2 = np.concatenate([e["reads"][len(e["reads"]) // 2 + ids]
                             for e, ids in zip(pool, picks)])
        a = pe_answers(text, m1, m2, error_rate, mapper["library_length"],
                       mapper["library_deviation"], mapper.get("rescue", True),
                       strata, cap)
        h = len(m1)
        return [(a[c0:c1], a[h + c0 : h + c1]) for c0, c1 in zip(cuts, cuts[1:])]
    r = np.concatenate([e["reads"][ids] for e, ids in zip(pool, picks)])
    a = se_answers(text, r, error_rate, strata, cap)
    return [a[c0:c1] for c0, c1 in zip(cuts, cuts[1:])]


def budget(read_len: int, error_rate: float) -> int:
    return (read_len * int(round(error_rate * 10_000))) // 10_000


INFO = ("sampled", "capped")    # counted, not compared


def _n_capped(want, paired: bool) -> int:
    return sum(a.capped for batch in want
               for a in ([x for p in batch for x in p] if paired else batch))


def run(cell, names, seqs, pool, sams: list, rng, examples=None) -> dict:
    """Counts of sampled reads at fault, by judge.NUMBERS, and the INFO
    counts: `sams[i]` is the SAM the window produced for the batch `pool[i]`."""
    m = cell.config["mapper"]
    text = Text.build(names, seqs)
    picks = draw(pool, int(cell.traffic["sample"]), rng)
    want = answers(text, pool, picks, m, m["error_rate"], seed_cap(cell.config))
    counts = dict.fromkeys(judge.NUMBERS, 0)
    sampled = 0
    for i, (e, ids) in enumerate(zip(pool, picks)):
        r = e["reads"]
        b = budget(r.shape[1], m["error_rate"])
        if e["paired"]:
            h = len(r) // 2
            got = judge.judge_pe(text, sams[i], [e["names"][j].encode() for j in ids],
                                 r[ids], r[h + ids], want[i][0], want[i][1], b,
                                 examples)
            sampled += 2 * len(ids)
        else:
            got = judge.judge_se(text, sams[i], [e["names"][j].encode() for j in ids],
                                 r[ids], want[i], b, examples)
            sampled += len(ids)
        for k, v in got.items():
            counts[k] += v
    counts["sampled"] = sampled
    counts["capped"] = _n_capped(want, pool[0]["paired"])
    return counts


def control(cell, names, seqs, pool, rng) -> dict:
    """The reference put in the program's place with one guarantee broken:
    it maps at an error budget one below the configuration's. Returns the
    same counts as `run`."""
    m = cell.config["mapper"]
    L = pool[0]["reads"].shape[1]
    low = (budget(L, m["error_rate"]) - 1) / L
    cap = seed_cap(cell.config)
    text = Text.build(names, seqs)
    picks = draw(pool, int(cell.traffic["sample"]), rng)
    want = answers(text, pool, picks, m, m["error_rate"], cap)
    got = answers(text, pool, picks, m, low, cap)
    counts = dict.fromkeys(judge.NUMBERS, 0)
    for e, g, w in zip(pool, got, want):
        pairs = list(zip(g, w)) if e["paired"] else [(g, w)]
        for gg, ww in pairs:
            for k, v in judge.judge_answers(gg, ww, e["paired"]).items():
                counts[k] += v
    counts["sampled"] = sum(len(ids) * (2 if e["paired"] else 1)
                            for e, ids in zip(pool, picks))
    counts["capped"] = _n_capped(want, pool[0]["paired"])
    return counts
