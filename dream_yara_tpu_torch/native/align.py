"""ctypes binding for the C++ CIGAR engine (align.cpp)."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .build import build

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = build("libdyalign.so")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.dy_cigars.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dy_cigars.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _p(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def compute_cigars_native(text, reads, rows, lengths, begins, ends, dists,
                          max_err: int, n_threads: int = 0):
    """Returns utils.packedstrs.PackedStrs (list-of-str compatible; the SAM
    formatter consumes the packed buffer directly, skipping 2x65k Python
    string materializations per batch)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native align library unavailable")
    n = len(rows)
    if n == 0:
        return []
    text = np.ascontiguousarray(text, dtype=np.int8)
    reads = np.ascontiguousarray(reads, dtype=np.int8)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    begins = np.ascontiguousarray(begins, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    dists = np.ascontiguousarray(dists, dtype=np.int32)
    cap = 64 * n + 4096
    while True:
        out = ctypes.create_string_buffer(cap)
        off = np.zeros(n + 1, dtype=np.int64)
        total = lib.dy_cigars(
            _p(text, ctypes.c_int8), len(text),
            _p(reads, ctypes.c_int8), reads.shape[1],
            _p(rows, ctypes.c_int32), _p(lengths, ctypes.c_int32),
            _p(begins, ctypes.c_int64), _p(ends, ctypes.c_int64),
            _p(dists, ctypes.c_int32),
            n, max_err, n_threads,
            out, cap, _p(off, ctypes.c_int64))
        if total >= 0:
            from ..utils.packedstrs import PackedStrs
            buf = np.frombuffer(out, dtype=np.uint8, count=int(total)).copy()
            return PackedStrs(buf, off)
        cap *= 4
        if cap > 1 << 31:
            raise RuntimeError("cigar buffer overflow")
