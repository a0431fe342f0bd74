"""FASTA reader/writer (host side).

Analog of the reference's SeqAn SeqFileIn usage in src/store_seqs.h [U].
Plain-Python line parsing with NumPy ASCII->code conversion; transparently
handles .gz. A C++ fast path lives in native/ (used when built; this module is
the always-available fallback and the behavioral spec).
"""

from __future__ import annotations

import gzip
import io
from pathlib import Path

import numpy as np

from ..utils.alphabet import ascii_to_code, code_to_ascii


def _open(path, mode="rb"):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fasta(path) -> tuple[list[str], list[np.ndarray]]:
    """Returns (names, [int8 code arrays]). Name = header up to first whitespace."""
    names: list[str] = []
    seqs: list[np.ndarray] = []
    chunks: list[bytes] = []

    def flush():
        if names:
            buf = np.frombuffer(b"".join(chunks), dtype=np.uint8)
            seqs.append(ascii_to_code(buf))
            chunks.clear()

    with _open(path) as fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                flush()
                names.append(line[1:].split()[0].decode())
            else:
                chunks.append(line)
        flush()
    if len(seqs) < len(names):  # header with no sequence lines
        seqs.append(np.zeros(0, dtype=np.int8))
    return names, seqs


def write_fasta(path, names, seqs, width: int = 70):
    with _open(path, "wb") as fh:
        for name, codes in zip(names, seqs):
            fh.write(b">" + name.encode() + b"\n")
            ascii_seq = code_to_ascii(np.asarray(codes, dtype=np.int8)).tobytes()
            for i in range(0, len(ascii_seq), width):
                fh.write(ascii_seq[i : i + width] + b"\n")
