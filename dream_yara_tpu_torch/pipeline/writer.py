"""SAM output — analog of reference src/mapper_writer.h MatchesWriter [U].

Produces the output contract of SURVEY.md §2.9: @HD/@SQ/@PG header with all
contigs of all bins in bin order; one record per read; FLAG bits for
paired/proper/unmapped/RC/secondary; POS/RNAME from the global contig table;
MAPQ per pipeline/mapq.py; CIGAR M/I/D; NM:i tag; secondary matches as records
(-sm record) or XA:Z tag (-sm tag) or omitted (-sm omit).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.readstore import ReadBatch
from ..io.seqstore import SeqStore
from ..utils.alphabet import code_to_ascii

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_RC = 0x10
FLAG_MATE_RC = 0x20
FLAG_FIRST = 0x40
FLAG_LAST = 0x80
FLAG_SECONDARY = 0x100


@dataclass
class GlobalContigs:
    """Contig table across all bins, in bin order (reference: the main
    mapper's global contig store with per-bin offsets, src/d_mapper.h
    copyMatches [U])."""

    names: list[str]
    lengths: np.ndarray       # (n_contigs,) int64
    starts: np.ndarray        # (n_contigs,) int64 — global coordinate of contig start
    bin_starts: np.ndarray    # (n_bins+1,) int64 — global coordinate of each bin's text

    @classmethod
    def from_stores(cls, stores: list[SeqStore]) -> "GlobalContigs":
        names, lengths, starts = [], [], []
        bin_starts = [0]
        pos = 0
        for st in stores:
            names.extend(st.names)
            lengths.extend(st.lengths.tolist())
            starts.extend((st.offsets + pos).tolist())
            pos += len(st.text)
            bin_starts.append(pos)
        return cls(names=names, lengths=np.array(lengths, dtype=np.int64),
                   starts=np.array(starts, dtype=np.int64),
                   bin_starts=np.array(bin_starts, dtype=np.int64))

    def contig_of(self, gpos: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.starts, gpos, side="right") - 1

    def same_contig_span(self, begin: np.ndarray, end: np.ndarray) -> np.ndarray:
        """True where [begin, end) lies fully inside one contig."""
        cb = self.contig_of(begin)
        ok = (cb >= 0) & (end > begin)
        ce_ok = end - 1 < self.starts[np.clip(cb, 0, None)] + self.lengths[np.clip(cb, 0, None)]
        return ok & ce_ok

    def local_pos(self, gpos: np.ndarray):
        cid = self.contig_of(gpos)
        return cid, gpos - self.starts[cid]


def sam_header(contigs: GlobalContigs, cmdline: str = "", version: str = "0.1.0",
               read_group: str | None = None) -> list[str]:
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    for name, length in zip(contigs.names, contigs.lengths):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(length)}")
    if read_group:
        lines.append(f"@RG\tID:{read_group}\tSM:{read_group}")
    pg = f"@PG\tID:dream-yara-tpu\tPN:dream-yara-tpu\tVN:{version}"
    if cmdline:
        pg += f"\tCL:{cmdline}"
    lines.append(pg)
    return lines


def _join(lines: list[str]) -> bytes:
    """Record lines -> one SAM byte blob (b'' when there are no records)."""
    return ("\n".join(lines) + "\n").encode() if lines else b""


def _pack_cigars(samfmt, cigars, idx, use):
    """(buffer, offsets) of cigars[idx[i]] where use[i] else ''. PackedStrs
    (native cigar engine output) gathers without materializing Python strs."""
    from ..utils.packedstrs import PackedStrs

    if isinstance(cigars, PackedStrs):
        return cigars.gather(idx, use)
    return samfmt.pack_strs([cigars[int(j)].encode() if u else b""
                             for j, u in zip(idx, use)])


def _write_se_native(batch: ReadBatch, contigs: GlobalContigs, ranked,
                     cigars: list[str], secondary_mode: str, samfmt,
                     read_group: str | None = None) -> bytes:
    """Vectorized field prep + C++ byte assembly (same output as the Python
    loop below, asserted by tests)."""
    from .mapq import compute_mapq

    n = batch.n_reads
    m = ranked.matches
    mapq_all = compute_mapq(ranked.c1, ranked.c2)
    ids = np.arange(n)
    grp_start = np.searchsorted(m.read_id, ids, side="left")
    grp_end = np.searchsorted(m.read_id, ids, side="right")
    mapped = grp_end > grp_start
    prim = np.where(mapped, grp_start, 0)

    if len(m):
        cid_all, lpos_all = contigs.local_pos(m.begin)
    else:
        cid_all = lpos_all = np.zeros(0, dtype=np.int64)

    strand = np.where(mapped, m.strand[prim], 0).astype(np.int32)
    flag = np.where(mapped, strand * FLAG_RC, FLAG_UNMAPPED).astype(np.int32)
    rname = np.where(mapped, cid_all[prim] if len(m) else 0, -1).astype(np.int32)
    pos1 = np.where(mapped, (lpos_all[prim] + 1) if len(m) else 0, 0).astype(np.int64)
    mapq = np.where(mapped, mapq_all[ids], 0).astype(np.int32)
    nm = np.where(mapped, m.dist[prim] if len(m) else 0, 0).astype(np.int32)

    names_b, name_off = samfmt.pack_strs([s.encode() for s in batch.names])
    cig_b, cig_off = _pack_cigars(samfmt, cigars, prim, mapped)
    # 2-bit codes straight through; the C++ formatter translates via LUT
    # while copying (saves a full ASCII materialization of the read matrix)
    seqmat = batch.seqs.view(np.uint8)
    seq_row = (ids + strand * n).astype(np.int32)
    seq_len = batch.lengths.astype(np.int32)
    quals_b, qual_off = samfmt.pack_strs(batch.quals)
    qual_rev = strand.astype(np.uint8)

    rg_tag = (("\tRG:Z:" + read_group).encode() if read_group else b"")
    extras = [rg_tag] * n
    if secondary_mode == "tag":
        for rid in np.flatnonzero(mapped & (grp_end - grp_start > 1)):
            s, e = int(grp_start[rid]), int(grp_end[rid])
            alts = []
            for mj in range(s + 1, e):
                st = "-" if m.strand[mj] else "+"
                alts.append(f"{contigs.names[int(cid_all[mj])]},{st}"
                            f"{int(lpos_all[mj]) + 1},{cigars[mj]},{int(m.dist[mj])}")
            extras[rid] = rg_tag + ("\tXA:Z:" + ";".join(alts) + ";").encode()
    extra_b, extra_off = samfmt.pack_strs(extras)
    cnames_b, cname_off = samfmt.pack_strs([s.encode() for s in contigs.names])

    rnext = np.full(n, -1, dtype=np.int32)
    zeros = np.zeros(n, dtype=np.int64)

    if secondary_mode == "record":
        rec, rec_read, is_sec, mj = _expand_secondary(
            n, mapped, grp_start, grp_end, prim,
            np.zeros(n, dtype=np.int32), m,
            cid_all, lpos_all, cigars,
            flag, rname, pos1, mapq, rnext, zeros, zeros,
            seq_row, seq_len, qual_rev, nm)
        names_enc = [s.encode() for s in batch.names]
        names_b, name_off = samfmt.pack_strs(
            [names_enc[r] for r in rec_read])
        cig_b, cig_off = _pack_cigars(
            samfmt, cigars,
            np.where(is_sec, mj, np.maximum(prim[rec_read], 0)),
            is_sec | mapped[rec_read])
        quals_b, qual_off = samfmt.pack_strs(
            [b"" if is_sec[i] else batch.quals[r]
             for i, r in enumerate(rec_read)])
        extra_b, extra_off = samfmt.pack_strs([rg_tag] * len(rec_read))
        has_nm = np.where(is_sec, 1, mapped[rec_read]).astype(np.uint8)
        text = samfmt.format_records(
            names_b, name_off, rec["flag"], rec["rname"], rec["pos1"],
            rec["mapq"], cig_b, cig_off, rec["rnext"], rec["pnext"],
            rec["tlen"], seqmat, rec["seq_row"], rec["seq_len"],
            quals_b, qual_off, rec["qual_rev"], has_nm, rec["nm"],
            extra_b, extra_off, cnames_b, cname_off, seq_codes=True)
        return text

    text = samfmt.format_records(
        names_b, name_off, flag, rname, pos1, mapq, cig_b, cig_off,
        rnext, zeros, zeros, seqmat, seq_row, seq_len,
        quals_b, qual_off, qual_rev, mapped.astype(np.uint8), nm,
        extra_b, extra_off, cnames_b, cname_off, seq_codes=True)
    return text


def _expand_secondary(n, mapped, grp_start, grp_end, prim, sec_flag_base,
                      m, cid_all, lpos_all, cigars,
                      flag, rname, pos1, mapq, rnext, pnext, tlen,
                      seq_row, seq_len, qual_rev, nm):
    """Interleave secondary records (-sm record) after each read's primary.

    Returns the record-level field arrays plus `rec_read` (owning read of
    each record), `is_sec`, and `mj` (match row of each secondary). The
    secondary fields follow the reference convention [U]: MAPQ 0, RNEXT '*',
    PNEXT/TLEN 0, SEQ/QUAL '*' (seq_len 0 + empty qual), own CIGAR and NM,
    flag = per-read base | RC-of-that-match | SECONDARY.
    """
    n_sec = np.where(mapped, np.maximum(grp_end - grp_start - 1, 0), 0)
    counts = 1 + n_sec
    total = int(counts.sum())
    rec_read = np.repeat(np.arange(n), counts)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    j = np.arange(total) - offs[rec_read]          # 0 = the primary record
    is_sec = j > 0
    base = grp_start[rec_read] + j - 1
    prim_c = np.where(mapped, prim, 0)[rec_read]
    mj = np.where(base >= prim_c, base + 1, base)  # group rows skipping prim
    mj = np.where(is_sec, mj, 0)

    sec_flag = (sec_flag_base[rec_read]
                | (m.strand[mj].astype(np.int32) * FLAG_RC if len(m)
                   else 0) | FLAG_SECONDARY)
    r = rec_read
    out = dict(
        flag=np.where(is_sec, sec_flag, flag[r]).astype(np.int32),
        rname=np.where(is_sec, cid_all[mj] if len(m) else 0,
                       rname[r]).astype(np.int32),
        pos1=np.where(is_sec, (lpos_all[mj] + 1) if len(m) else 0,
                      pos1[r]).astype(np.int64),
        mapq=np.where(is_sec, 0, mapq[r]).astype(np.int32),
        rnext=np.where(is_sec, -1, rnext[r]).astype(np.int32),
        pnext=np.where(is_sec, 0, pnext[r]).astype(np.int64),
        tlen=np.where(is_sec, 0, tlen[r]).astype(np.int64),
        seq_row=np.where(is_sec, 0, seq_row[r]).astype(np.int32),
        seq_len=np.where(is_sec, 0, seq_len[r]).astype(np.int32),
        qual_rev=np.where(is_sec, 0, qual_rev[r]).astype(np.uint8),
        nm=np.where(is_sec, m.dist[mj] if len(m) else 0, nm[r]).astype(np.int32),
    )
    return out, rec_read, is_sec, mj


def _write_pe_native(batch: ReadBatch, contigs: GlobalContigs, ranked,
                     cigars: list[str], pair_info, secondary_mode: str,
                     samfmt, read_group: str | None = None) -> bytes:
    """Vectorized PE field prep + C++ byte assembly (mirrors the Python
    write_pe_records loop exactly; tested equal)."""
    from .mapq import compute_mapq

    n = batch.n_reads
    h = n // 2
    m = ranked.matches
    ids = np.arange(n)
    mate = np.where(ids < h, ids + h, ids - h)
    prim = pair_info.primary_idx
    mate_p = prim[mate]
    mapped = prim >= 0
    mate_mapped = mate_p >= 0
    pc = np.where(mapped, prim, 0).astype(np.int64)
    mc = np.where(mate_mapped, mate_p, 0).astype(np.int64)
    has_m = len(m) > 0
    my_strand = (m.strand[pc].astype(np.int32) if has_m else np.zeros(n, np.int32)) * mapped
    mate_strand = (m.strand[mc].astype(np.int32) if has_m else np.zeros(n, np.int32)) * mate_mapped

    flag = (np.full(n, FLAG_PAIRED, dtype=np.int32)
            | np.where(ids < h, FLAG_FIRST, FLAG_LAST)
            | np.where(mapped, 0, FLAG_UNMAPPED)
            | np.where(mate_mapped, 0, FLAG_MATE_UNMAPPED)
            | my_strand * FLAG_RC
            | mate_strand * FLAG_MATE_RC
            | pair_info.proper.astype(np.int32) * FLAG_PROPER)

    if has_m:
        cid_all, lpos_all = contigs.local_pos(m.begin)
        my_cid = cid_all[pc]
        my_pos1 = lpos_all[pc] + 1
        mate_cid = cid_all[mc]
        mate_pos1 = lpos_all[mc] + 1
        my_beg, my_end = m.begin[pc], m.end[pc]
        mt_beg, mt_end = m.begin[mc], m.end[mc]
    else:
        my_cid = my_pos1 = mate_cid = mate_pos1 = np.zeros(n, np.int64)
        my_beg = my_end = mt_beg = mt_end = np.zeros(n, np.int64)

    rname = np.where(mapped, my_cid,
                     np.where(mate_mapped, mate_cid, -1)).astype(np.int32)
    pos1 = np.where(mapped, my_pos1,
                    np.where(mate_mapped, mate_pos1, 0)).astype(np.int64)
    mapq = np.where(mapped, compute_mapq(ranked.c1, ranked.c2)[ids], 0).astype(np.int32)
    nm = np.where(mapped, m.dist[pc] if has_m else 0, 0).astype(np.int32)

    both = mapped & mate_mapped
    same = both & (my_cid == mate_cid)
    t = np.maximum(my_end, mt_end) - np.minimum(my_beg, mt_beg)
    left = (my_beg < mt_beg) | ((my_beg == mt_beg) & (ids < h))
    tlen = np.where(same, np.where(left, t, -t), 0).astype(np.int64)
    rnext = np.where(~mapped & ~mate_mapped, -1,
                     np.where(both & ~same, mate_cid, -2)).astype(np.int32)
    pnext = np.where(~mapped & ~mate_mapped, 0,
                     np.where(mate_mapped, mate_pos1, my_pos1)).astype(np.int64)

    names_b, name_off = samfmt.pack_strs([s.encode() for s in batch.names])
    cig_b, cig_off = _pack_cigars(samfmt, cigars, pc, mapped)
    seqmat = batch.seqs.view(np.uint8)   # codes; C++ LUT-translates
    seq_row = (ids + my_strand * n).astype(np.int32)
    seq_len = batch.lengths.astype(np.int32)
    quals_b, qual_off = samfmt.pack_strs(batch.quals)
    qual_rev = my_strand.astype(np.uint8)

    grp_start = np.searchsorted(m.read_id, ids, side="left")
    grp_end = np.searchsorted(m.read_id, ids, side="right")
    rg_tag = (("\tRG:Z:" + read_group).encode() if read_group else b"")
    extras = [rg_tag] * n
    if secondary_mode == "tag":
        for rid in np.flatnonzero(mapped & (grp_end - grp_start > 1)):
            s, e = int(grp_start[rid]), int(grp_end[rid])
            alts = []
            for mj in range(s, e):
                if mj == prim[rid]:
                    continue
                st = "-" if m.strand[mj] else "+"
                alts.append(f"{contigs.names[int(cid_all[mj])]},{st}"
                            f"{int(lpos_all[mj]) + 1},{cigars[mj]},{int(m.dist[mj])}")
            extras[rid] = rg_tag + ("\tXA:Z:" + ";".join(alts) + ";").encode()
    extra_b, extra_off = samfmt.pack_strs(extras)
    cnames_b, cname_off = samfmt.pack_strs([s.encode() for s in contigs.names])

    if secondary_mode == "record":
        sec_base = (np.full(n, FLAG_PAIRED, dtype=np.int32)
                    | np.where(ids < h, FLAG_FIRST, FLAG_LAST)
                    | np.where(mate_mapped, 0, FLAG_MATE_UNMAPPED)
                    | mate_strand * FLAG_MATE_RC)
        rec, rec_read, is_sec, mj = _expand_secondary(
            n, mapped, grp_start, grp_end, prim, sec_base, m,
            cid_all if has_m else np.zeros(0, np.int64),
            lpos_all if has_m else np.zeros(0, np.int64), cigars,
            flag, rname, pos1, mapq, rnext, pnext, tlen,
            seq_row, seq_len, qual_rev, nm)
        names_enc = [s.encode() for s in batch.names]
        names_b, name_off = samfmt.pack_strs(
            [names_enc[r] for r in rec_read])
        cig_b, cig_off = _pack_cigars(
            samfmt, cigars,
            np.where(is_sec, mj, np.maximum(prim[rec_read], 0)),
            is_sec | mapped[rec_read])
        quals_b, qual_off = samfmt.pack_strs(
            [b"" if is_sec[i] else batch.quals[r]
             for i, r in enumerate(rec_read)])
        extra_b, extra_off = samfmt.pack_strs([rg_tag] * len(rec_read))
        has_nm = np.where(is_sec, 1, mapped[rec_read]).astype(np.uint8)
        text = samfmt.format_records(
            names_b, name_off, rec["flag"], rec["rname"], rec["pos1"],
            rec["mapq"], cig_b, cig_off, rec["rnext"], rec["pnext"],
            rec["tlen"], seqmat, rec["seq_row"], rec["seq_len"],
            quals_b, qual_off, rec["qual_rev"], has_nm, rec["nm"],
            extra_b, extra_off, cnames_b, cname_off, seq_codes=True)
        return text

    text = samfmt.format_records(
        names_b, name_off, flag, rname, pos1, mapq, cig_b, cig_off,
        rnext, pnext, tlen, seqmat, seq_row, seq_len,
        quals_b, qual_off, qual_rev, mapped.astype(np.uint8), nm,
        extra_b, extra_off, cnames_b, cname_off, seq_codes=True)
    return text


def _seq_qual(batch: ReadBatch, read_id: int, strand: int) -> tuple[str, str]:
    l = int(batch.lengths[read_id])
    row = batch.seq_row(read_id, reverse=bool(strand))
    seq = code_to_ascii(batch.seqs[row, :l]).tobytes().decode()
    qual = batch.quals[read_id].decode() or "*"
    if strand:
        qual = qual[::-1]
    return seq, qual


def write_pe_records(batch: ReadBatch, contigs: GlobalContigs, ranked,
                     cigars: list[str], pair_info,
                     secondary_mode: str = "tag",
                     read_group: str | None = None) -> bytes:
    """Paired-end records. Reads [0,h) are first mates, [h,2h) second mates.

    TLEN (both mates mapped, same contig): rightmost end - leftmost begin,
    positive on the leftmost mate (mate1 wins ties). Unmapped read with a
    mapped mate takes the mate's RNAME/POS (SAM pairing convention).

    Dispatches to the C++ formatter for tag/omit modes (semantics identical
    to the Python loop; tested equal).
    """
    from .mapq import compute_mapq

    try:
        from ..native import samfmt

        if samfmt.available():
            return _write_pe_native(batch, contigs, ranked, cigars,
                                    pair_info, secondary_mode, samfmt,
                                    read_group)
    except ImportError:
        pass

    m = ranked.matches
    mapq = compute_mapq(ranked.c1, ranked.c2)
    n = batch.n_reads
    h = n // 2
    if len(m):
        cid_all, lpos_all = contigs.local_pos(m.begin)
    else:
        cid_all = lpos_all = np.zeros(0, dtype=np.int64)
    grp_start = np.searchsorted(m.read_id, np.arange(n), side="left")
    grp_end = np.searchsorted(m.read_id, np.arange(n), side="right")
    prim = pair_info.primary_idx

    lines = []
    for rid in range(n):
        mate = rid + h if rid < h else rid - h
        mate_flag = FLAG_FIRST if rid < h else FLAG_LAST
        name = batch.names[rid]
        my_p, mate_p = int(prim[rid]), int(prim[mate])
        mapped = my_p >= 0
        mate_mapped = mate_p >= 0

        flag = FLAG_PAIRED | mate_flag
        if not mapped:
            flag |= FLAG_UNMAPPED
        if not mate_mapped:
            flag |= FLAG_MATE_UNMAPPED
        if mapped and m.strand[my_p]:
            flag |= FLAG_RC
        if mate_mapped and m.strand[mate_p]:
            flag |= FLAG_MATE_RC
        if pair_info.proper[rid]:
            flag |= FLAG_PROPER

        if mate_mapped:
            mate_cid = int(cid_all[mate_p])
            mate_pos1 = int(lpos_all[mate_p]) + 1
        rg = f"\tRG:Z:{read_group}" if read_group else ""
        if not mapped:
            seq, qual = _seq_qual(batch, rid, 0)
            if mate_mapped:
                rname = contigs.names[mate_cid]
                lines.append(f"{name}\t{flag}\t{rname}\t{mate_pos1}\t0\t*"
                             f"\t=\t{mate_pos1}\t0\t{seq}\t{qual}{rg}")
            else:
                lines.append(f"{name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qual}{rg}")
            continue

        my_cid = int(cid_all[my_p])
        my_pos1 = int(lpos_all[my_p]) + 1
        if mate_mapped:
            if mate_cid == my_cid:
                rnext, pnext = "=", mate_pos1
                left = (int(m.begin[my_p]), rid >= h)
                lmate = (int(m.begin[mate_p]), mate >= h)
                t = int(max(m.end[my_p], m.end[mate_p])
                        - min(m.begin[my_p], m.begin[mate_p]))
                tlen = t if left < lmate else -t
            else:
                rnext, pnext, tlen = contigs.names[mate_cid], mate_pos1, 0
        else:
            rnext, pnext, tlen = "=", my_pos1, 0

        strand = int(m.strand[my_p])
        seq, qual = _seq_qual(batch, rid, strand)
        tags = [f"NM:i:{int(m.dist[my_p])}"]
        if read_group:
            tags.append(f"RG:Z:{read_group}")     # native order: NM, RG, XA
        s, e = int(grp_start[rid]), int(grp_end[rid])
        if secondary_mode == "tag" and e - s > 1:
            alts = []
            for mj in range(s, e):
                if mj == my_p:
                    continue
                cj = int(cid_all[mj])
                st = "-" if m.strand[mj] else "+"
                alts.append(f"{contigs.names[cj]},{st}{int(lpos_all[mj]) + 1},"
                            f"{cigars[mj]},{int(m.dist[mj])}")
            tags.append("XA:Z:" + ";".join(alts) + ";")
        lines.append(f"{name}\t{flag}\t{contigs.names[my_cid]}\t{my_pos1}"
                     f"\t{int(mapq[rid])}\t{cigars[my_p]}\t{rnext}\t{pnext}"
                     f"\t{tlen}\t{seq}\t{qual}\t" + "\t".join(tags))
        if secondary_mode == "record":
            for mj in range(s, e):
                if mj == my_p:
                    continue
                sflag = (FLAG_PAIRED | mate_flag | FLAG_SECONDARY
                         | (FLAG_RC if m.strand[mj] else 0)
                         | (0 if mate_mapped else FLAG_MATE_UNMAPPED)
                         | (FLAG_MATE_RC if mate_mapped and m.strand[mate_p] else 0))
                cj = int(cid_all[mj])
                lines.append(f"{name}\t{sflag}\t{contigs.names[cj]}"
                             f"\t{int(lpos_all[mj]) + 1}\t0\t{cigars[mj]}"
                             f"\t*\t0\t0\t*\t*\tNM:i:{int(m.dist[mj])}"
                             + rg)
    return _join(lines)


def write_se_records(batch: ReadBatch, contigs: GlobalContigs, ranked,
                     cigars: list[str], secondary_mode: str = "tag",
                     read_group: str | None = None) -> bytes:
    """Single-end records, one primary per read (+ secondaries per mode).

    ranked: pipeline.matches.Ranked (canonical order); cigars aligned with
    ranked.matches rows. Dispatches to the C++ formatter (native/samfmt.cpp)
    for tag/omit modes; field semantics are identical (tested equal).
    """
    from .mapq import compute_mapq

    try:
        from ..native import samfmt

        if samfmt.available():
            return _write_se_native(batch, contigs, ranked, cigars,
                                    secondary_mode, samfmt, read_group)
    except ImportError:
        pass
    return _write_se_python(batch, contigs, ranked, cigars, secondary_mode,
                            read_group)


def _write_se_python(batch: ReadBatch, contigs: GlobalContigs, ranked,
                     cigars: list[str], secondary_mode: str = "tag",
                     read_group: str | None = None) -> bytes:
    from .mapq import compute_mapq

    m = ranked.matches
    mapq = compute_mapq(ranked.c1, ranked.c2)
    cid_all, lpos_all = contigs.local_pos(m.begin)

    # group match indices per read (matches sorted by read_id)
    grp_start = np.searchsorted(m.read_id, np.arange(batch.n_reads), side="left")
    grp_end = np.searchsorted(m.read_id, np.arange(batch.n_reads), side="right")

    lines = []
    for rid in range(batch.n_reads):
        name = batch.names[rid]
        s, e = int(grp_start[rid]), int(grp_end[rid])
        rg = f"\tRG:Z:{read_group}" if read_group else ""
        if s == e:  # unmapped
            seq, qual = _seq_qual(batch, rid, 0)
            lines.append(f"{name}\t{FLAG_UNMAPPED}\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qual}{rg}")
            continue
        for k, mi in enumerate(range(s, e)):
            strand = int(m.strand[mi])
            flag = (FLAG_RC if strand else 0) | (0 if k == 0 else FLAG_SECONDARY)
            if k > 0 and secondary_mode != "record":
                break
            rname = contigs.names[int(cid_all[mi])]
            pos1 = int(lpos_all[mi]) + 1
            q = int(mapq[rid]) if k == 0 else 0
            seq, qual = ("*", "*") if k > 0 else _seq_qual(batch, rid, strand)
            tags = [f"NM:i:{int(m.dist[mi])}"]
            if read_group:
                tags.append(f"RG:Z:{read_group}")   # native order: NM, RG, XA
            if k == 0 and secondary_mode == "tag" and e - s > 1:
                alts = []
                for mj in range(s + 1, e):
                    cj = int(cid_all[mj])
                    st = "-" if m.strand[mj] else "+"
                    alts.append(f"{contigs.names[cj]},{st}{int(lpos_all[mj]) + 1},"
                                f"{cigars[mj]},{int(m.dist[mj])}")
                tags.append("XA:Z:" + ";".join(alts) + ";")
            lines.append(f"{name}\t{flag}\t{rname}\t{pos1}\t{q}\t{cigars[mi]}"
                         f"\t*\t0\t0\t{seq}\t{qual}\t" + "\t".join(tags))
    return _join(lines)
