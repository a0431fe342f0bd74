"""ctypes binding for the 2-bit read packer (readpack.cpp)."""

from __future__ import annotations

import ctypes

import numpy as np

from .build import build

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = build("libdyreadpack.so")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.dy_pack_reads.argtypes = [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.dy_pack_reads.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def pack_reads(seqs_fwd: np.ndarray, half: int, L: int,
               packed_out: np.ndarray, nmask_out: np.ndarray) -> None:
    """Fill packed (half, Wp) / nmask (half, Wn) uint32 outputs in place."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native readpack unavailable")
    seqs = np.ascontiguousarray(seqs_fwd, dtype=np.int8)
    assert packed_out.flags.c_contiguous and nmask_out.flags.c_contiguous
    lib.dy_pack_reads(
        seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        seqs.shape[0], seqs.shape[1], L, half,
        packed_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        nmask_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
