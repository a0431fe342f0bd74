"""Byte-packed string list: one contiguous buffer + int64 offsets.

Used for CIGAR strings on the hot output path: the C++ cigar engine
(native/align.cpp) emits all strings into one buffer, and the C++ SAM
formatter (native/samfmt.cpp) consumes (buffer, offsets) directly — per-item
Python str objects are only materialized on demand (XA tags, golden model,
tests), never for the bulk of records.
"""

from __future__ import annotations

import numpy as np


class PackedStrs:
    __slots__ = ("buf", "off")

    def __init__(self, buf: np.ndarray, off: np.ndarray):
        self.buf = np.asarray(buf, dtype=np.uint8)
        self.off = np.asarray(off, dtype=np.int64)

    @classmethod
    def from_list(cls, items) -> "PackedStrs":
        bs = [s.encode() if isinstance(s, str) else bytes(s) for s in items]
        off = np.zeros(len(bs) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in bs], out=off[1:])
        return cls(np.frombuffer(b"".join(bs), dtype=np.uint8), off)

    def __len__(self) -> int:
        return len(self.off) - 1

    def __getitem__(self, i) -> str:
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = int(i)
        if i < 0:
            i += len(self)
        return self.buf[self.off[i] : self.off[i + 1]].tobytes().decode()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PackedStrs):
            return (len(self) == len(other)
                    and np.array_equal(self.off, other.off)
                    and np.array_equal(self.buf, other.buf))
        try:
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        except TypeError:
            return NotImplemented

    def gather(self, idx: np.ndarray, keep: np.ndarray | None = None):
        """(buffer, offsets) of items [self[i] for i in idx], with items
        where ``keep`` is False replaced by the empty string — the formatter
        prints '*' for zero-length CIGARs. Pure vector ops, no Python loop."""
        idx = np.asarray(idx, dtype=np.int64)
        lens = self.off[idx + 1] - self.off[idx]
        if keep is not None:
            lens = np.where(keep, lens, 0)
        off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        tot = int(off[-1])
        if tot == 0:
            return np.zeros(0, dtype=np.uint8), off
        pos = (np.arange(tot, dtype=np.int64)
               - np.repeat(off[:-1], lens)
               + np.repeat(self.off[idx], lens))
        return self.buf[pos], off
