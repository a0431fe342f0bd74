"""BAM/BGZF output — analog of the reference's BamFileOut path
(src/mapper_writer.h writes SAM or BAM via SeqAn [U]; SURVEY.md §2.3).

The encoder converts finished SAM text (header + records from
pipeline/writer.py) into spec-compliant BAM: binary records packed per the
SAM spec §4.2, wrapped in BGZF blocks (gzip members with the BC extra
subfield, <= 64 KiB uncompressed each, closed by the fixed EOF marker).
Reusing the SAM field preparation keeps every writer feature (FLAG
semantics, MAPQ, XA/secondary modes, mate fields) bit-consistent across
both formats; tests/test_bam.py re-parses the output with an independent
reader and diffs it field-by-field against the SAM.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_MAX_BLOCK = 65280

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def bgzf_compress(data: bytes, level: int = 6) -> bytes:
    """data -> concatenated BGZF blocks (no EOF marker; see bgzf_eof)."""
    out = []
    for i in range(0, len(data), _MAX_BLOCK):
        chunk = data[i : i + _MAX_BLOCK]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        payload = co.compress(chunk) + co.flush()
        bsize = len(payload) + 25 + 1  # header(18) + payload + crc+isize(8)
        block = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                 + struct.pack("<H", 6)           # XLEN
                 + b"BC" + struct.pack("<HH", 2, bsize - 1)
                 + payload
                 + struct.pack("<II", zlib.crc32(chunk), len(chunk)))
        out.append(block)
    return b"".join(out)


def _cigar_bin(cigar: str) -> list[int]:
    """'12M1I8M' -> packed uint32 ops (op_len << 4 | op)."""
    if cigar == "*":
        return []
    ops, num = [], 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            ops.append((num << 4) | _CIGAR_OPS.index(ch))
            num = 0
    return ops


def _pack_tags(fields: list[str]) -> bytes:
    out = bytearray()
    for f in fields:
        tag, typ, val = f.split(":", 2)
        out += tag.encode()
        if typ == "i":
            v = int(val)
            out += b"i" + struct.pack("<i", v)
        elif typ == "A":
            out += b"A" + val.encode()[:1]
        elif typ == "f":
            out += b"f" + struct.pack("<f", float(val))
        else:  # Z (and any string-ish fallback)
            out += b"Z" + val.encode() + b"\x00"
    return bytes(out)


def _reg2bin(beg: int, end: int) -> int:
    """SAM spec §5.3 bin number of [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _ref_len_from_cigar(cigar: str, seq_len: int) -> int:
    if cigar == "*":
        return 1
    n, num = 0, 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            if ch in "MDN=X":
                n += num
            num = 0
    return max(n, 1)


def bam_header(header_lines: list[str]) -> tuple[bytes, dict]:
    """BAM header block from SAM @-lines; returns (bytes, name->refID)."""
    text = ("\n".join(header_lines) + "\n").encode()
    refs = []
    for l in header_lines:
        if l.startswith("@SQ"):
            d = dict(f.split(":", 1) for f in l.split("\t")[1:])
            refs.append((d["SN"], int(d["LN"])))
    out = bytearray(b"BAM\x01")
    out += struct.pack("<i", len(text)) + text
    out += struct.pack("<i", len(refs))
    for name, ln in refs:
        nb = name.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    return bytes(out), {name: i for i, (name, _) in enumerate(refs)}


def bam_record(fields: list[str], ref_ids: dict) -> bytes:
    """One SAM record line (split fields) -> BAM binary record."""
    qname, flag, rname, pos1, mapq, cigar, rnext, pnext1, tlen, seq, qual = \
        fields[:11]
    flag = int(flag)
    ref_id = ref_ids.get(rname, -1)
    pos = int(pos1) - 1
    next_ref = (ref_id if rnext == "=" else ref_ids.get(rnext, -1))
    next_pos = int(pnext1) - 1
    cig = _cigar_bin(cigar)
    l_seq = 0 if seq == "*" else len(seq)
    name_b = qname.encode() + b"\x00"
    bin_ = (_reg2bin(pos, pos + _ref_len_from_cigar(cigar, l_seq))
            if pos >= 0 else 4680)
    rec = bytearray()
    rec += struct.pack("<iiBBHHHiiii", ref_id, pos, len(name_b),
                       int(mapq), bin_, len(cig), flag, l_seq,
                       next_ref, next_pos, int(tlen))
    rec += name_b
    rec += struct.pack(f"<{len(cig)}I", *cig)
    if l_seq:
        codes = np.frombuffer(seq.encode(), dtype=np.uint8)
        nib = np.zeros(l_seq, dtype=np.uint8)
        for ch, v in _SEQ_NIBBLE.items():
            nib[codes == ord(ch)] = v
        nib[np.isin(codes, np.frombuffer(b"acmgrsvtwyhkdbn", np.uint8))] = 15
        if l_seq % 2:
            nib = np.append(nib, 0)
        rec += ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()
        if qual == "*":
            rec += b"\xff" * l_seq
        else:
            q = np.frombuffer(qual.encode(), dtype=np.uint8) - 33
            rec += q.astype(np.uint8).tobytes()
    return bytes(rec) + _pack_tags(fields[11:])


def sam_records_to_bam_body(lines: list[str], ref_ids: dict) -> bytes:
    out = bytearray()
    for l in lines:
        if not l or l.startswith("@"):
            continue
        body = bam_record(l.split("\t"), ref_ids)
        out += struct.pack("<i", len(body)) + body
    return bytes(out)


class BamWriter:
    """Streaming .bam writer: header once, then per-batch SAM text."""

    def __init__(self, fileobj):
        self.f = fileobj
        self.ref_ids: dict | None = None

    def write_sam(self, sam_text: str | bytes):
        if isinstance(sam_text, bytes):
            sam_text = sam_text.decode()   # BAM re-parses fields as str
        lines = sam_text.splitlines()
        if self.ref_ids is None:
            header = [l for l in lines if l.startswith("@")]
            hdr, self.ref_ids = bam_header(header)
            self.f.write(bgzf_compress(hdr))
        body = sam_records_to_bam_body(lines, self.ref_ids)
        if body:
            self.f.write(bgzf_compress(body))

    def close(self):
        self.f.write(BGZF_EOF)
        self.f.close()
