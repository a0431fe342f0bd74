"""ctypes binding for the bit-scatter loop (scatter.cpp)."""

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
    path = build("libdyscatter.so")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.dy_scatter_or_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
    ]
    lib.dy_scatter_or_u32.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def scatter_or(words: np.ndarray, rows: np.ndarray, word_col: int, bit: int):
    """words[rows, word_col] |= bit (in place)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native scatter unavailable")
    assert words.flags.c_contiguous and words.dtype == np.uint32
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    lib.dy_scatter_or_u32(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(rows), words.shape[1], word_col, np.uint32(bit))
