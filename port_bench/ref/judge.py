"""Judge the SAM records of sampled reads against the reference's answers.

A record is first checked by what it says of itself (`invalid`): its SEQ
is the read on the strand its FLAG names; its CIGAR, laid on the
reference's own text at its position, costs exactly its NM, spans the
read and stays inside its contig; NM is within the read's budget; every
XA alternative holds the same way; a mate's RNEXT, PNEXT, mate flags and
TLEN agree with its mate's record. Then its answer is held against the
reference's: mapped or not and the best distance (`best_miss`), the set
of kept matches (`set_miss`), MAPQ (`mapq_miss`), the primary match or
its absence and, for pairs, the proper flag and TLEN (`primary_miss`).
A read the reference marks `capped` (a seed of it has more hits in a bin
than the mapper keeps) is held to its best distance alone: its set, and
with it MAPQ and the primary, may be a subset. Each number counts the
sampled reads at fault.
"""

from __future__ import annotations

import numpy as np

from .align import SEP, cigar_cost
from .mapper import Answer, Text, revcomp_rows

LETTERS = np.frombuffer(b"ACGTN", np.uint8)
NUMBERS = ("missing", "invalid", "best_miss", "set_miss", "mapq_miss",
           "primary_miss")


def records_by_name(sam: bytes, names: set[bytes]) -> dict:
    """Primary records of the wanted read names: {name: [fields, ...]}."""
    out: dict = {}
    for line in sam.split(b"\n"):
        if not line or line[:1] == b"@":
            continue
        name, _, rest = line.partition(b"\t")
        if name in names:
            f = rest.split(b"\t")
            if int(f[0]) & 0x900 == 0:
                out.setdefault(name, []).append([name] + f)
    return out


class _Rec:
    def __init__(self, f):
        self.flag = int(f[1])
        self.rname, self.pos1, self.mapq = f[2], int(f[3]), int(f[4])
        self.cigar, self.rnext, self.pnext, self.tlen = f[5], f[6], int(f[7]), int(f[8])
        self.seq = f[9]
        self.tags = {t[:2]: t[5:] for t in f[11:]}


def _loc(text: Text, rname: bytes, pos1: int):
    cid = text.ids.get(rname.decode())
    return None if cid is None else int(text.starts[cid]) + pos1 - 1


def _check_alignment(text: Text, read: np.ndarray, rc: bool, rname, pos1,
                     cigar, nm: int, budget: int):
    """The match (strand, begin, end, nm) a record or XA entry states, or
    None where it does not hold."""
    g = _loc(text, rname, pos1)
    if g is None or nm > budget:
        return None
    seq = revcomp_rows(read[None])[0] if rc else read
    got = cigar_cost(seq, text.text, g, cigar)
    if got is None:
        return None
    edits, span, qlen = got
    if edits != nm or qlen != len(read) or (text.text[g : g + span] == SEP).any():
        return None
    return (int(rc), g, g + span, nm)


def program_answer(text: Text, rec: _Rec, read: np.ndarray, budget: int):
    """(Answer, valid) of one primary record."""
    seq = np.frombuffer(rec.seq, np.uint8)
    rc = bool(rec.flag & 0x10)
    want = LETTERS[revcomp_rows(read[None])[0] if rc else read]
    valid = len(seq) == len(want) and bool((seq == want).all())
    if rec.flag & 0x4:
        return Answer([], rec.mapq), valid and rec.mapq == 0
    nm = rec.tags.get(b"NM")
    m = None if nm is None else _check_alignment(
        text, read, rc, rec.rname, rec.pos1, rec.cigar, int(nm), budget)
    if m is None:
        return Answer([], rec.mapq), False
    matches = [m]
    xa = rec.tags.get(b"XA", b"")
    for alt in filter(None, xa.split(b";")):
        parts = alt.split(b",")
        if len(parts) != 4 or parts[1][:1] not in (b"+", b"-"):
            return Answer(matches, rec.mapq), False
        x = _check_alignment(text, read, parts[1][:1] == b"-", parts[0],
                             int(parts[1][1:]), parts[2], int(parts[3]), budget)
        if x is None:
            return Answer(matches, rec.mapq), False
        matches.append(x)
    return Answer(matches, rec.mapq, bool(rec.flag & 0x2), rec.tlen), valid


def _mate_fields_ok(text: Text, me: _Rec, mate: _Rec, me_first: bool,
                    a: Answer, b: Answer) -> bool:
    """A mate's RNEXT, PNEXT, TLEN and mate flags against its mate's record."""
    if bool(me.flag & 0x8) != bool(mate.flag & 0x4):
        return False
    if bool(me.flag & 0x2) != bool(mate.flag & 0x2):
        return False
    if not a.mapped and not b.mapped:
        return me.rname == b"*" and me.rnext == b"*" and me.tlen == 0
    if not a.mapped:        # placed at its mate
        return (me.rname, me.pos1, me.rnext, me.pnext, me.tlen) == (
            mate.rname, mate.pos1, b"=", mate.pos1, 0)
    if bool(me.flag & 0x20) != bool(mate.flag & 0x10) and b.mapped:
        return False
    if not b.mapped:
        return me.rnext == b"=" and me.pnext == me.pos1 and me.tlen == 0
    same = me.rname == mate.rname
    if me.rnext != (b"=" if same else mate.rname) or me.pnext != mate.pos1:
        return False
    if not same:
        return me.tlen == 0
    x, y = a.matches[0], b.matches[0]
    t = max(x[2], y[2]) - min(x[1], y[1])
    left = x[1] < y[1] or (x[1] == y[1] and me_first)
    return me.tlen == (t if left else -t)


def compare(got: Answer, want: Answer, paired: bool) -> dict:
    """Which of the reference comparisons this read fails."""
    miss = dict.fromkeys(NUMBERS[2:], False)
    if got.mapped != want.mapped or got.best != want.best:
        miss["best_miss"] = True
    if want.capped:
        return miss
    if set(got.matches) != set(want.matches):
        miss["set_miss"] = True
    if got.mapq != want.mapq:
        miss["mapq_miss"] = True
    if (got.matches[:1], got.mapped) != (want.matches[:1], want.mapped):
        miss["primary_miss"] = True        # its primary, or "unmapped"
    if paired and (got.proper, got.tlen) != (want.proper, want.tlen):
        miss["primary_miss"] = True
    return miss


def _note(examples, name, got, want, miss):
    """Keep up to two examples of each kind of miss, for the log."""
    if examples is None:
        return
    kinds = [k for k, v in miss.items() if v]
    if kinds and sum(1 for e in examples if e[1][0] == kinds[0]) < 2:
        examples.append((name.decode(), kinds, got.matches[:8], got.mapq,
                         want.matches[:8], want.mapq))


def judge_se(text: Text, sam: bytes, names: list[bytes], reads: np.ndarray,
             want: list[Answer], budget: int, examples: list | None = None) -> dict:
    """Counts over sampled single-end reads (`names[i]` is read `reads[i]`)."""
    recs = records_by_name(sam, set(names))
    counts = dict.fromkeys(NUMBERS, 0)
    for i, name in enumerate(names):
        rs = recs.get(name, [])
        if len(rs) != 1:
            counts["missing"] += 1
            continue
        got, valid = program_answer(text, _Rec(rs[0]), reads[i], budget)
        counts["invalid"] += not valid
        miss = compare(got, want[i], False)
        _note(examples, name, got, want[i], miss)
        for k, v in miss.items():
            counts[k] += v
    return counts


def judge_pe(text: Text, sam: bytes, names: list[bytes], mates1, mates2,
             want1: list[Answer], want2: list[Answer], budget: int,
             examples: list | None = None) -> dict:
    """Counts over the mates of sampled pairs (`names[i]` names pair i)."""
    recs = records_by_name(sam, set(names))
    counts = dict.fromkeys(NUMBERS, 0)
    for i, name in enumerate(names):
        rs = recs.get(name, [])
        first = [r for r in rs if int(r[1]) & 0x40]
        last = [r for r in rs if int(r[1]) & 0x80]
        if len(rs) != 2 or len(first) != 1 or len(last) != 1:
            counts["missing"] += 2
            continue
        r1, r2 = _Rec(first[0]), _Rec(last[0])
        a1, v1 = program_answer(text, r1, mates1[i], budget)
        a2, v2 = program_answer(text, r2, mates2[i], budget)
        v1 = v1 and _mate_fields_ok(text, r1, r2, True, a1, a2)
        v2 = v2 and _mate_fields_ok(text, r2, r1, False, a2, a1)
        counts["invalid"] += (not v1) + (not v2)
        for got, want in ((a1, want1[i]), (a2, want2[i])):
            miss = compare(got, want, True)
            _note(examples, name, got, want, miss)
            for k, v in miss.items():
                counts[k] += v
    return counts


def judge_answers(got: list[Answer], want: list[Answer], paired: bool) -> dict:
    """Counts of answers that did not come through SAM (the control)."""
    counts = dict.fromkeys(NUMBERS, 0)
    for g, w in zip(got, want):
        for k, v in compare(g, w, paired).items():
            counts[k] += v
    return counts
