"""ctypes binding for the C++ SA-IS engine (sais.cpp)."""

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
    path = build("libdysais.so")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    sig = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.dy_sais_u8.argtypes = sig
    lib.dy_sais_u8.restype = ctypes.c_int32
    if hasattr(lib, "dy_sais_u8_into"):
        lib.dy_sais_u8_into.argtypes = sig
        lib.dy_sais_u8_into.restype = ctypes.c_int32
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def suffix_array(text: np.ndarray,
                 tmp_dir: str | None = None) -> np.ndarray:
    """O(n) suffix array of an int8/uint8 code array.

    tmp_dir: optional external-memory mode — the output SA is an
    unlinked file-backed memmap under tmp_dir (OS-paged)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native SA-IS library unavailable")
    t = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(t)
    if n == 0:
        return np.empty(0, dtype=np.int32)
    if hasattr(lib, "dy_sais_u8_into"):
        # low-memory path: the engine writes into our n+1 buffer directly
        # (row 0 = virtual sentinel) — no internal int32 text/SA copies;
        # peak working set ~6 bytes/char (see sais.cpp header comment)
        if tmp_dir is not None:
            # external-memory mode (--tmp-dir): back the SA with an
            # unlinked mmap'd file so the OS can page it out; the mapping
            # outlives the unlink, so no cleanup is needed
            import os
            import tempfile

            fd, path = tempfile.mkstemp(prefix="dysa.", dir=tmp_dir)
            try:
                os.ftruncate(fd, (n + 1) * 4)
                sa1 = np.memmap(path, dtype=np.int32, mode="r+",
                                shape=(n + 1,))
            finally:
                os.close(fd)
                os.unlink(path)
        else:
            sa1 = np.empty(n + 1, dtype=np.int32)
        rc = lib.dy_sais_u8_into(
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(n))
        if rc == 0:
            return sa1[1:]
        # rc != 0: a byte value 255 exists — fall through to the general path
    sa = np.empty(n, dtype=np.int32)
    lib.dy_sais_u8(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(n))
    return sa
