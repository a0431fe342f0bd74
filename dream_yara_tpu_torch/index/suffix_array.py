"""Suffix array construction (host side, offline indexer path).

Analog of reference SeqAn `indexCreate(index, FibreSALF())` (SURVEY.md §2.4):
SA construction is the indexer's hot spot and runs on host, not TPU — it is a
one-time offline cost. Two engines:

  * `build_suffix_array(text)` — dispatches to the C++ SA-IS engine
    (native/sais.cpp via ctypes, O(n)) when built, else NumPy prefix-doubling
    (O(n log n), fully vectorized — no Python-level loop over characters).
  * `sa_numpy(text)` — the NumPy engine, also the test oracle for small inputs.

The suffix array is over the int8 code text produced by SeqStore (codes 0..5,
SENTINEL-separated contigs). Result dtype is int32 (bins are < 2^31 bases).
"""

from __future__ import annotations

import numpy as np


def sa_numpy(text: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (Manber-Myers) with numpy argsort."""
    n = len(text)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    rank = np.asarray(text, dtype=np.int64).copy()
    sa = np.argsort(rank, kind="stable").astype(np.int64)
    k = 1
    tmp = np.empty(n, dtype=np.int64)
    while True:
        # key = (rank[i], rank[i+k]) with rank[-] = -1 past the end
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        # sort by second then first (stable) == sort by (first, second)
        order = np.argsort(second, kind="stable")
        order = order[np.argsort(rank[order], kind="stable")]
        sa = order
        # re-rank
        prev = sa[:-1]
        curr = sa[1:]
        newgroup = (rank[curr] != rank[prev]) | (second[curr] != second[prev])
        tmp[sa[0]] = 0
        tmp[sa[1:]] = np.cumsum(newgroup)
        rank, tmp = tmp, rank
        if rank[sa[-1]] == n - 1:
            return sa.astype(np.int32)
        k *= 2


def build_suffix_array(text: np.ndarray,
                       tmp_dir: str | None = None) -> np.ndarray:
    """Best available engine: C++ SA-IS if built, else numpy doubling.

    tmp_dir: external-memory mode (reference indexer `--tmp-dir`,
    SURVEY.md §2.1/§2.4 [U]): the 4n-byte suffix array lives in an
    unlinked memory-mapped file under tmp_dir instead of anonymous RAM,
    so the OS pages it to disk under memory pressure — bins whose SA
    exceeds free RAM still build. The SA-IS engine writes into the map
    directly (native/sais.cpp dy_sais_u8_into).
    """
    try:
        from ..native import sais

        if sais.available():
            return sais.suffix_array(text, tmp_dir=tmp_dir)
    except ImportError:
        pass
    return sa_numpy(text)
