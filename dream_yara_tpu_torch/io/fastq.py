"""FASTQ reader with batched, optionally paired iteration.

Analog of reference src/file_pair.h / file_prefetched.h [U]: the reference
overlaps FASTQ decoding with compute via a prefetch thread; here
FastqBatchReader decodes the *next* batch on a background thread while the
device maps the current one (same double-buffering idea, host→TPU edition).
"""

from __future__ import annotations

import gzip
import threading
from queue import Queue

import numpy as np

from ..utils.alphabet import ascii_to_code
from .readstore import ReadBatch


def _open(path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _parse_records(fh, limit):
    """Yield (name, seq_codes, qual_bytes) for up to `limit` records (None = all)."""
    count = 0
    while limit is None or count < limit:
        header = fh.readline()
        if not header:
            return
        seq = fh.readline().rstrip()
        fh.readline()  # '+'
        qual = fh.readline().rstrip()
        name = header[1:].rstrip().split()[0].decode() if header.startswith(b"@") else ""
        yield name, ascii_to_code(np.frombuffer(seq, dtype=np.uint8)), qual
        count += 1


def read_fastq(path, limit=None):
    """Whole-file read: returns (names, [codes], [qual bytes])."""
    names, seqs, quals = [], [], []
    with _open(path) as fh:
        for name, codes, qual in _parse_records(fh, limit):
            names.append(name)
            seqs.append(codes)
            quals.append(qual)
    return names, seqs, quals


class FastqBatchReader:
    """Iterate ReadBatch objects of `batch_size` reads (pairs count as 2 reads).

    Single-end: pass one path. Paired-end: pass both; records are interleaved
    as [mates1..., mates2...] within a batch, mirroring the reference's read
    layout arithmetic (bits_reads.h: getMateSeqId [U], see ReadBatch).
    """

    def __init__(self, path1, path2=None, batch_size=100_000, prefetch=True):
        self.path1, self.path2 = path1, path2
        self.pairs = path2 is not None
        self.batch_size = batch_size
        self.prefetch = prefetch

    def _batches(self):
        try:
            from ..native import seqio as nat
            if nat.available():
                yield from self._batches_native(nat)
                return
        except Exception:
            pass  # fall back to the pure-Python parser
        yield from self._batches_python()

    def _batches_native(self, nat, max_len: int = 512):
        """C++ chunk parser -> dense matrices -> ReadBatch (no per-record
        Python objects; see native/seqio.cpp)."""
        p1 = nat.FastqChunkParser(self.path1, max_len=max_len)
        p2 = nat.FastqChunkParser(self.path2, max_len=max_len) if self.pairs else None
        per_file = self.batch_size // 2 if self.pairs else self.batch_size
        try:
            while True:
                names, seqs, lens, quals = p1.next_records(per_file)
                n1 = len(names)
                if n1 == 0:
                    return
                if p2 is not None:
                    names2, seqs2, lens2, quals2 = p2.next_records(n1)
                    if len(names2) != n1:
                        raise ValueError(
                            "paired FASTQ files have unequal record counts")
                    names = names + names2
                    seqs = np.concatenate([seqs, seqs2])
                    lens = np.concatenate([lens, lens2])
                    quals = np.concatenate([quals, quals2])
                lmax = max(1, int(lens.max()))
                qlist = [quals[i, : lens[i]].tobytes() for i in range(len(lens))]
                yield ReadBatch.from_dense(names, seqs[:, :lmax], lens,
                                           quals=qlist, paired=self.pairs)
                if n1 < per_file:
                    return
        finally:
            p1.close()
            if p2 is not None:
                p2.close()

    def _batches_python(self):
        fh1 = _open(self.path1)
        fh2 = _open(self.path2) if self.pairs else None
        per_file = self.batch_size // 2 if self.pairs else self.batch_size
        try:
            while True:
                names, seqs, quals = [], [], []
                n1 = 0
                for name, codes, qual in _parse_records(fh1, per_file):
                    names.append(name); seqs.append(codes); quals.append(qual)
                    n1 += 1
                if n1 == 0:
                    return
                if fh2 is not None:
                    n2 = 0
                    for name, codes, qual in _parse_records(fh2, n1):
                        names.append(name); seqs.append(codes); quals.append(qual)
                        n2 += 1
                    if n2 != n1:
                        raise ValueError("paired FASTQ files have unequal record counts")
                yield ReadBatch.from_reads(names, seqs, quals, paired=self.pairs)
                if n1 < per_file:
                    return
        finally:
            fh1.close()
            if fh2 is not None:
                fh2.close()

    def __iter__(self):
        if not self.prefetch:
            yield from self._batches()
            return
        q: Queue = Queue(maxsize=2)
        sentinel = object()
        err: list[BaseException] = []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
