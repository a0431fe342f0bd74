"""ctypes binding for the C++ FASTQ chunk parser (seqio.cpp)."""

from __future__ import annotations

import ctypes
import gzip

import numpy as np

from .build import build

_lib = None
_tried = False

READ_CHUNK = 8 << 20  # bytes pulled from the file per refill


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = build("libdyseqio.so")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.dy_fastq_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dy_fastq_parse.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class FastqChunkParser:
    """Streams dense record blocks out of one FASTQ file."""

    def __init__(self, path, max_len: int = 1024):
        self.fh = gzip.open(path, "rb") if str(path).endswith(".gz") \
            else open(path, "rb")
        self.max_len = max_len
        self.buf = b""
        self.eof = False
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("native seqio library unavailable")

    def close(self):
        self.fh.close()

    def next_records(self, count: int):
        """Up to `count` records: (names, seqs (k,max_len) int8, lengths,
        quals (k,max_len) uint8). Empty k on EOF."""
        L = self.max_len
        seqs = np.full((count, L), 4, dtype=np.int8)
        quals = np.full((count, L), ord("I"), dtype=np.uint8)
        lengths = np.zeros(count, dtype=np.int32)
        name_cap = 256 * count
        while True:
            if not self.eof and len(self.buf) < READ_CHUNK:
                data = self.fh.read(READ_CHUNK)
                if not data:
                    self.eof = True
                self.buf += data
            names_buf = np.zeros(name_cap, dtype=np.uint8)
            name_off = np.zeros(count + 1, dtype=np.int64)
            n_out = ctypes.c_int32(0)
            consumed = self.lib.dy_fastq_parse(
                self.buf, len(self.buf), count, L,
                seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                quals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                names_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                name_cap, ctypes.byref(n_out))
            if consumed < 0:
                name_cap *= 4
                continue
            k = int(n_out.value)
            if k < count and not self.eof:
                # incomplete tail records: pull more bytes and re-parse
                data = self.fh.read(READ_CHUNK)
                if data:
                    self.buf += data
                else:
                    self.eof = True
                continue
            self.buf = self.buf[consumed:]
            nb = names_buf.tobytes()
            names = [nb[name_off[i] : name_off[i + 1]].decode()
                     for i in range(k)]
            return names, seqs[:k], lengths[:k], quals[:k]
