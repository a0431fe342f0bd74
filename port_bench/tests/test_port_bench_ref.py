"""The plain reference on hand-made reads: a unique read, a repeat read,
a paired read with its mate, and a read that lies in no bin."""

from __future__ import annotations

import numpy as np

from port_bench.ref import align, judge, seeds
from port_bench.ref.mapper import PAD, Answer, Text, mapq, pe_answers, se_answers

COMP = np.array([3, 2, 1, 0, 4], np.int8)


def rc(x):
    return COMP[x][::-1]


def scalar_verify(text, anchor, read, E):
    """The contract's banded DP, one lane, written out cell by cell."""
    W, m, INF = 2 * E + 1, len(read), 1 << 20

    def ch(x):
        p = anchor - E + x
        return int(text[p]) if 0 <= p < len(text) else 6

    D, S = [0] * W, list(range(W))
    for j in range(m):
        nD, nS = [], []
        for d in range(W):
            diag = D[d] + (read[j] != ch(j + d) or read[j] >= 4 or ch(j + d) >= 4)
            up = D[d + 1] + 1 if d + 1 < W else INF
            if up < diag:
                nD.append(up), nS.append(S[d + 1])
            else:
                nD.append(diag), nS.append(S[d])
        for d in range(1, W):
            if nD[d - 1] + 1 < nD[d]:
                nD[d], nS[d] = nD[d - 1] + 1, nS[d - 1]
        D, S = nD, nS
    b = min(D)
    d = D.index(b)
    return b, anchor - E + S[d], anchor - E + m + d


def test_banded_verify_equals_the_scalar_dp():
    rng = np.random.default_rng(3)
    text = rng.integers(0, 4, 4000).astype(np.int8)
    text[100:110] = 4
    lanes, reads = [], []
    for _ in range(300):
        a = int(rng.integers(-5, 3900))
        r = text[max(a, 0) : max(a, 0) + 60].copy()
        r = np.resize(r, 60)
        for _ in range(int(rng.integers(0, 4))):
            j = int(rng.integers(0, 60))
            r[j] = (r[j] + 1) % 4
        if rng.random() < 0.3:                 # an indel
            j = int(rng.integers(1, 59))
            r = np.concatenate([r[:j], r[j + 1 :], [int(rng.integers(0, 4))]]).astype(np.int8)
        lanes.append(a + int(rng.integers(-2, 3)))
        reads.append(r)
    d, b, e = align.banded_verify(text, np.array(lanes), np.stack(reads), 3)
    for i in range(len(lanes)):
        # the reference pads outside the text with separators: same as 6
        assert (d[i], b[i], e[i]) == scalar_verify(text, lanes[i], reads[i], 3)


def test_cigar_cost():
    text = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int8)
    read = np.array([0, 1, 3, 0, 1], np.int8)      # text[0:6] with G deleted
    assert align.cigar_cost(read, text, 0, b"2M1D3M") == (1, 6, 5)
    assert align.cigar_cost(read, text, 0, b"5M") == (3, 5, 5)
    assert align.cigar_cost(read, text, 0, b"2X3M") is None


def test_seed_occurrences_equal_brute_force():
    rng = np.random.default_rng(5)
    text = rng.integers(0, 4, 20_000).astype(np.int8)
    text[5000:5050] = 4
    text[9000:9030] = text[100:130]                # a repeat
    q = np.stack([text[p : p + 30] for p in (100, 4990, 333, 19_000)])
    q = q[(q < 4).all(1)]
    qi, pos = seeds.occurrences(text, q)
    win = np.lib.stride_tricks.sliding_window_view(text, 30)
    for i in range(len(q)):
        assert np.array_equal(np.sort(pos[qi == i]),
                              np.flatnonzero((win == q[i]).all(1)))
    assert (qi == 0).sum() == 2


def _db():
    rng = np.random.default_rng(11)
    seqs = [rng.integers(0, 4, 3000).astype(np.int8) for _ in range(3)]
    rep = rng.integers(0, 4, 120).astype(np.int8)
    seqs[0][500:620] = rep                         # one copy in bin 0 ...
    seqs[2][1000:1120] = rep                       # ... and one in bin 2
    return ["b0", "b1", "b2"], seqs


def test_reference_answers_hand_made_reads():
    names, seqs = _db()
    text = Text.build(names, seqs)
    unique = seqs[1][200:300].copy()
    unique[[10, 50]] = (unique[[10, 50]] + 1) % 4  # two substitutions
    repeat = seqs[0][510:610].copy()               # inside both copies
    novel = np.random.default_rng(99).integers(0, 4, 100).astype(np.int8)
    reads = np.stack([unique, rc(repeat), novel])
    a = se_answers(text, reads, 0.03)
    assert a[0].matches == [(0, int(text.starts[1]) + 200, int(text.starts[1]) + 300, 2)]
    assert a[0].mapq == 40
    assert {m[1] for m in a[1].matches} == {int(text.starts[0]) + 510,
                                          int(text.starts[2]) + 1010}
    assert all(m[0] == 1 and m[3] == 0 for m in a[1].matches)
    assert a[1].mapq == mapq(2, 0) == 3
    assert not a[2].mapped and a[2].mapq == 0


def test_reference_pairs_a_pe_read():
    names, seqs = _db()
    text = Text.build(names, seqs)
    m1 = seqs[1][1000:1150]
    m2 = rc(seqs[1][1200:1350])                     # insert 350
    a = pe_answers(text, m1[None], m2[None], 0.03, 350, 80)
    s1 = int(text.starts[1])
    assert a[0].matches[0] == (0, s1 + 1000, s1 + 1150, 0)
    assert a[1].matches[0] == (1, s1 + 1200, s1 + 1350, 0)
    assert a[0].proper and a[1].proper
    assert (a[0].tlen, a[1].tlen) == (350, -350)


def test_judge_reads_a_sam_record_and_finds_faults():
    names, seqs = _db()
    text = Text.build(names, seqs)
    read = seqs[1][200:300].copy()
    want = se_answers(text, read[None], 0.03)
    seq = bytes(np.frombuffer(b"ACGTN", np.uint8)[read])
    good = b"r0\t0\tb1\t201\t40\t100M\t*\t0\t0\t" + seq + b"\t*\tNM:i:0\n"
    assert judge.judge_se(text, good, [b"r0"], read[None], want, 3) == dict.fromkeys(
        judge.NUMBERS, 0)
    shifted = good.replace(b"\t201\t", b"\t202\t")
    got = judge.judge_se(text, shifted, [b"r0"], read[None], want, 3)
    assert got["invalid"] == 1
    assert judge.judge_se(text, b"", [b"r0"], read[None], want, 3)["missing"] == 1
    unmapped = b"r0\t4\t*\t0\t0\t*\t*\t0\t0\t" + seq + b"\t*\n"
    got = judge.judge_se(text, unmapped, [b"r0"], read[None], want, 3)
    assert got["best_miss"] == 1 and got["invalid"] == 0
    assert PAD > 2 * 31 + 1


def test_a_read_with_a_seed_over_the_cap_is_capped_and_judged_by_its_best():
    names, seqs = _db()
    unit = seqs[1][2000:2025].copy()               # one 25 bp seed ...
    for p in (100, 400, 700, 1000, 1300):          # ... six times in bin 1
        seqs[1][p : p + 25] = unit
    text = Text.build(names, seqs)
    read = seqs[1][2000:2100].copy()               # seed 0 is the unit
    plain = seqs[1][200:300].copy()
    reads = np.stack([read, plain])
    assert [a.capped for a in se_answers(text, reads, 0.03)] == [False, False]
    a = se_answers(text, reads, 0.03, cap=4)
    assert [x.capped for x in a] == [True, False]
    assert [x.capped for x in se_answers(text, reads, 0.03, cap=6)] == [False, False]
    # a capped read that keeps a subset of its best matches is held to its
    # best distance alone
    sub = Answer(a[0].matches[:1], 0)
    assert judge.compare(sub, a[0], False) == dict.fromkeys(judge.NUMBERS[2:], False)
    plain_sub = Answer([], 0)
    assert judge.compare(plain_sub, a[1], False)["set_miss"]
    # a pair with one capped mate is capped on both mates
    assert not se_answers(text, rc(seqs[1][2250:2350])[None], 0.03, cap=4)[0].capped
    p = pe_answers(text, read[None], rc(seqs[1][2250:2350])[None], 0.03, 350, 80,
                   cap=4)
    assert p[0].capped and p[1].capped
