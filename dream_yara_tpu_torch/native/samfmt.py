"""ctypes binding for the C++ SAM formatter (samfmt.cpp)."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .build import build

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = build("libdysamfmt.so")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.dy_format_records.argtypes = [
        ctypes.c_int32,
        i8p, i64p,                 # names
        i32p, i32p, i64p, i32p,    # flag, rname, pos1, mapq
        i8p, i64p,                 # cigar
        i32p, i64p, i64p,          # rnext, pnext, tlen
        i8p, ctypes.c_int64, i32p, i32p, ctypes.c_int32,  # seqmat/stride/row/len/codes
        i8p, i64p, i8p,            # quals, off, rev
        i8p, i32p,                 # has_nm, nm
        i8p, i64p,                 # extra
        i8p, i64p,                 # contig names
        i8p, ctypes.c_int64,       # out
    ]
    lib.dy_format_records.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _p8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def pack_strs(items: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    off = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in items], out=off[1:])
    return np.frombuffer(b"".join(items), dtype=np.uint8), off


# Grow-only output scratch, reused across batches. A fresh ~150 MB
# np.empty per call costs a ~0.7 s page-fault storm on first touch inside
# the C loop (measured: first call lib=0.80s, warm reuse 0.06s for the same
# 250k-record batch); keeping the arena alive makes every batch warm.
# One arena per thread: format_records may run on a worker thread while the
# main thread finishes a previous batch, and a shared buffer would
# interleave two batches' bytes.
_tls = threading.local()


def format_records(names_b, name_off, flag, rname_idx, pos1, mapq,
                   cig_b, cig_off, rnext_idx, pnext, tlen,
                   seqmat, seq_row, seq_len,
                   quals_b, qual_off, qual_rev, has_nm, nm,
                   extra_b, extra_off, cnames_b, cname_off,
                   seq_codes: bool = False) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("native samfmt unavailable")
    # enforce exact dtypes: ctypes pointers reinterpret raw memory, so an
    # int64 array passed as int32* silently reads garbage
    flag = np.ascontiguousarray(flag, dtype=np.int32)
    rname_idx = np.ascontiguousarray(rname_idx, dtype=np.int32)
    pos1 = np.ascontiguousarray(pos1, dtype=np.int64)
    mapq = np.ascontiguousarray(mapq, dtype=np.int32)
    rnext_idx = np.ascontiguousarray(rnext_idx, dtype=np.int32)
    pnext = np.ascontiguousarray(pnext, dtype=np.int64)
    tlen = np.ascontiguousarray(tlen, dtype=np.int64)
    seq_row = np.ascontiguousarray(seq_row, dtype=np.int32)
    seq_len = np.ascontiguousarray(seq_len, dtype=np.int32)
    qual_rev = np.ascontiguousarray(qual_rev, dtype=np.uint8)
    has_nm = np.ascontiguousarray(has_nm, dtype=np.uint8)
    nm = np.ascontiguousarray(nm, dtype=np.int32)
    n = len(flag)
    # Mirror the C++ per-record bound: contig names are untrusted FASTA
    # headers of arbitrary length, so budget the longest one for both RNAME
    # and RNEXT of every record; QUAL gets its true packed length.
    max_cname = int(np.max(np.diff(cname_off))) if len(cname_off) > 1 else 1
    cap = int(name_off[-1] + cig_off[-1] + int(seq_len.sum()) + qual_off[-1]
              + extra_off[-1] + (2 * max_cname + 256) * n + 1024)
    out = getattr(_tls, "scratch", None)
    if out is None or out.shape[0] < cap:
        out = np.empty(cap + cap // 4, dtype=np.uint8)
        out[::4096] = 0               # pre-fault once, outside the C loop
        _tls.scratch = out
    seqmat = np.ascontiguousarray(seqmat, dtype=np.uint8)
    total = lib.dy_format_records(
        n, _p8(names_b), _p64(name_off),
        _p32(flag), _p32(rname_idx), _p64(pos1), _p32(mapq),
        _p8(cig_b), _p64(cig_off),
        _p32(rnext_idx), _p64(pnext), _p64(tlen),
        _p8(seqmat), seqmat.shape[1], _p32(seq_row), _p32(seq_len),
        int(bool(seq_codes)),
        _p8(quals_b), _p64(qual_off), _p8(qual_rev),
        _p8(has_nm), _p32(nm),
        _p8(extra_b), _p64(extra_off), _p8(cnames_b), _p64(cname_off),
        _p8(out), cap)
    if total < 0:
        raise RuntimeError("samfmt buffer overflow")
    return out[:total].tobytes()
