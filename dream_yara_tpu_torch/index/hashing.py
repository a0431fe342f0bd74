"""K-mer extraction and IBF hashing — shared host (numpy) definition.

The device (jnp) implementation in ops/ibf_query.py reproduces EXACTLY this
arithmetic; tests assert host/device hash equality. All arithmetic is uint32
with wraparound so the TPU (no 64-bit ints) and host agree bit-for-bit.

K-mer value convention: kmer_lo/hi are the 2-bit packed window with the FIRST
base in the LEAST significant bits of lo; bases 16..k-1 go to hi. k <= 32.
Only windows free of N/sentinel are valid (reference inserts Dna-only k-mers
from bin fastas, src/d_build_filter.cpp [U,M]).
"""

from __future__ import annotations

import numpy as np

# Odd multiplicative seeds for the n_hashes hash functions (first n used).
HASH_SEEDS = np.array(
    [0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1,
     0xD3A2646D, 0xFD7046C5, 0xB55A4F09],
    dtype=np.uint32,
)
MIX_MULT = np.uint32(0x85EBCA6B)


def kmer_windows(codes: np.ndarray, k: int):
    """All k-length windows of `codes` as packed (lo, hi) uint32 + validity mask.

    Returns (lo, hi, valid) each of shape (len(codes) - k + 1,); empty if the
    sequence is shorter than k.
    """
    codes = np.asarray(codes, dtype=np.int64)
    n = len(codes)
    m = n - k + 1
    if m <= 0:
        z = np.zeros(0, dtype=np.uint32)
        return z, z.copy(), np.zeros(0, dtype=bool)
    lo = np.zeros(m, dtype=np.int64)
    hi = np.zeros(m, dtype=np.int64)
    masked = codes & 3
    for t in range(min(k, 16)):
        lo |= masked[t : m + t] << (2 * t)
    for t in range(16, k):
        hi |= masked[t : m + t] << (2 * (t - 16))
    bad = (codes >= 4).astype(np.int64)
    cbad = np.concatenate([[0], np.cumsum(bad)])
    valid = (cbad[k:] - cbad[:-k]) == 0
    return lo.astype(np.uint32), hi.astype(np.uint32), valid


def canonical_windows(codes: np.ndarray, k: int):
    """Strand-CANONICAL packed windows: elementwise min(fwd, revcomp) by
    (hi, lo) lexicographic order. A window and its reverse complement share
    one canonical value, so a filter built canonically answers BOTH read
    orientations from the forward read's windows alone — the classify side
    then hashes HALF the rows and skips the orientation OR
    (ops/ibf_query.py; the reference inserts forward k-mers and queries
    both orientations [U] — same answers, half the row gathers)."""
    lo_f, hi_f, valid = kmer_windows(codes, k)
    codes = np.asarray(codes, dtype=np.int64)
    m = len(codes) - k + 1
    if m <= 0:
        return lo_f, hi_f, valid
    comp = 3 - (codes & 3)
    lo_r = np.zeros(m, dtype=np.int64)
    hi_r = np.zeros(m, dtype=np.int64)
    # rc window base t = complement of fwd base (k-1-t) within the window
    for t in range(min(k, 16)):
        lo_r |= comp[k - 1 - t : k - 1 - t + m] << (2 * t)
    for t in range(16, k):
        hi_r |= comp[k - 1 - t : k - 1 - t + m] << (2 * (t - 16))
    lo_r = lo_r.astype(np.uint32)
    hi_r = hi_r.astype(np.uint32)
    swap = (hi_r < hi_f) | ((hi_r == hi_f) & (lo_r < lo_f))
    return (np.where(swap, lo_r, lo_f), np.where(swap, hi_r, hi_f), valid)


def fmix32(h: np.ndarray) -> np.ndarray:
    """murmur3 32-bit finalizer — full-avalanche bijection on uint32.

    Needed because row selection uses a modulo, which keeps LOW bits: without a
    finalizer, (kmer * seed) % n_rows depends only on the kmer's low bits and
    all hash functions collide together (observed as massive IBF false
    positives during verification).
    """
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h ^= h >> np.uint32(13)
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h ^= h >> np.uint32(16)
    return h


def ibf_rows(lo: np.ndarray, hi: np.ndarray, n_hashes: int, n_rows: int) -> np.ndarray:
    """Hash rows for each kmer: shape (len(lo), n_hashes) int64 in [0, n_rows)."""
    mix = (lo ^ (hi * MIX_MULT)).astype(np.uint32)
    seeds = HASH_SEEDS[:n_hashes]
    v = fmix32(mix[:, None] ^ seeds[None, :])
    v = (v & np.uint32(0x7FFFFFFF)).astype(np.int64)
    return v % np.int64(n_rows)


BLOCK_WORDS = 128  # uint32 words per gatherable filter block (512 B row)


def ibf_blocked_rows(lo: np.ndarray, hi: np.ndarray, n_hashes: int,
                     n_rows: int, words_per_row: int) -> np.ndarray:
    """Blocked-layout hash rows: all n_hashes probes of a k-mer land inside
    ONE 128-word block (S = 128/words_per_row consecutive rows), so the
    device query gathers a single 512 B block row per window instead of
    n_hashes scattered words — gathers cost per INDEX on TPU
    (tools/proto_gather_rate.py), row width is nearly free. Probe sub-rows
    are base + j*stride mod S with an odd stride (S is a power of two), so
    the n_hashes probes are distinct. Same (nk, n_hashes) shape/contract as
    ibf_rows; classic cache-blocked Bloom analysis applies (slightly higher
    FP at equal bits, irrelevant at k-mer-lemma routing thresholds)."""
    S = BLOCK_WORDS // words_per_row
    n_blocks = n_rows // S
    mix = (lo ^ (hi * MIX_MULT)).astype(np.uint32)
    v0 = fmix32(mix ^ HASH_SEEDS[0])
    block = ((v0 & np.uint32(0x7FFFFFFF)).astype(np.int64)
             % np.int64(n_blocks))
    v1 = fmix32(mix ^ HASH_SEEDS[1])
    base = (v1 & np.uint32(S - 1)).astype(np.int64)
    stride = (((v1 >> np.uint32(8)) & np.uint32(S - 1))
              | np.uint32(1)).astype(np.int64)
    j = np.arange(n_hashes, dtype=np.int64)
    sub = (base[:, None] + j[None, :] * stride[:, None]) % np.int64(S)
    return block[:, None] * np.int64(S) + sub


def minimizer_select(lo: np.ndarray, hi: np.ndarray, valid: np.ndarray,
                     w: int, k: int) -> np.ndarray:
    """Winnowing selection mask over the k-mer windows of one sequence.

    A k-mer is selected iff it is the minimizer (smallest fmix32 mix key,
    leftmost on ties) of at least one length-w window (w >= k; w == k
    selects everything). Invalid k-mers (N/sentinel) never win. The device
    classifier (ops/ibf_query.py) reproduces this selection bit-for-bit.
    """
    m = len(lo)
    W0 = w - k + 1
    if W0 <= 1 or m == 0:
        return valid.copy()
    key = fmix32((lo ^ (hi * MIX_MULT)).astype(np.uint32)).astype(np.uint64)
    key = np.where(valid, key, np.uint64(0xFFFFFFFF))
    # augment with position for a strict leftmost tie-break
    aug = (key << np.uint64(32)) | np.arange(m, dtype=np.uint64)
    n_win = m - W0 + 1
    if n_win <= 0:
        # sequence shorter than one full window: single window over all
        sel = np.zeros(m, dtype=bool)
        if valid.any():
            sel[int(np.argmin(aug))] = True
        return sel & valid
    from numpy.lib.stride_tricks import sliding_window_view

    argm = np.argmin(sliding_window_view(aug, W0), axis=1)
    sel = np.zeros(m, dtype=bool)
    sel[argm + np.arange(n_win)] = True
    return sel & valid
