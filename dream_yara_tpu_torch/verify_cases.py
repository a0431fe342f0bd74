"""Candidate generators for the banded-verify kernel (numpy, from a seeded
generator): lanes of the single-bin entry and of the stacked-text entry,
with the edge anchors the kernels must treat as the reference does. The
smoke run (chip_smoke.py) and the card-only tests draw their cases here.
"""

from __future__ import annotations

import numpy as np


def verify_case(rng, text: np.ndarray, C: int, L: int, E: int):
    """Candidates for banded verification, vectorised: reads cut from the
    text at their anchor shifted by up to E (indel-like offsets), with
    substitutions, some N, some shorter reads and some random reads; read
    rows are a permutation of the lanes. Returns numpy arrays
    (anchors, reads, read_rows, lengths)."""
    n = len(text)
    anchors = rng.integers(0, n - L - E, C).astype(np.int32)
    shift = rng.integers(-E, E + 1, C)
    pos = np.clip(anchors[:, None] + shift[:, None] + np.arange(L)[None, :],
                  0, n - 1)
    reads = text[pos].copy()
    sub = rng.random((C, L)) < 0.02
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    reads[rng.random((C, L)) < 0.002] = 4
    noise = rng.random(C) < 0.05
    reads[noise] = rng.integers(0, 4, (int(noise.sum()), L))
    lengths = np.full(C, L, np.int32)
    short = rng.random(C) < 0.1
    lengths[short] = rng.integers(1, L + 1, int(short.sum()))
    reads[np.arange(L)[None, :] >= lengths[:, None]] = 4
    perm = rng.permutation(C).astype(np.int32)
    return anchors, reads[perm].astype(np.int8), np.argsort(perm).astype(np.int32), lengths


def edge_case(text: np.ndarray, anchors, reads, read_rows, lengths):
    """Anchors at 0, near and past the text end and negative; length-0 lanes."""
    n = len(text)
    anchors[:8] = [0, 1, n - 10, n - 1, n + 5, -1, -3, -40]
    lengths[8:12] = 0
    read_rows[12] = reads.shape[0] + 7           # outside the read matrix
    return anchors, reads, read_rows, lengths


def stacked_case(rng, bin_lens, C: int, L: int, E: int, edges: bool):
    """Candidates on a stack of bins of unequal length (numpy): the
    (B, max_n) text stack padded with 7, each lane's bin, and reads cut at
    their anchor in their bin as verify_case cuts them. With `edges`,
    anchors sit at 0, at 1, at and past each bin's end and before its
    start (tests/test_pallas.py's layout). Returns (text, bin_n, lane_bin,
    anchors, reads, read_rows, lengths)."""
    B = len(bin_lens)
    n_max = int(max(bin_lens))
    text = np.full((B, n_max), 7, np.int8)
    for b, n in enumerate(bin_lens):
        text[b, :n] = rng.integers(0, 4, n)
    bin_n = np.asarray(bin_lens, np.int32)
    lane_bin = rng.integers(0, B, C).astype(np.int32)
    n_lane = bin_n[lane_bin].astype(np.int64)
    anchors = (rng.random(C) * (n_lane - L - E)).astype(np.int32)
    shift = rng.integers(-E, E + 1, C)
    pos = np.clip(anchors[:, None] + shift[:, None] + np.arange(L)[None, :], 0,
                  n_lane[:, None] - 1)
    reads = text[lane_bin[:, None], pos]
    sub = rng.random((C, L)) < 0.02
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    noise = rng.random(C) < 0.05
    reads[noise] = rng.integers(0, 4, (int(noise.sum()), L))
    lengths = np.full(C, L, np.int32)
    short = rng.random(C) < 0.1
    lengths[short] = rng.integers(1, L + 1, int(short.sum()))
    reads[np.arange(L)[None, :] >= lengths[:, None]] = 4
    if edges:
        k = np.arange(min(C, 8 * B))
        b = (k % B).astype(np.int32)
        lane_bin[k] = b
        n_b = bin_n[b]
        anchors[k] = np.choose(k // B % 8, [np.zeros_like(n_b), np.ones_like(n_b),
                                            n_b - L, n_b - 10, n_b - 1, n_b + 5,
                                            np.full_like(n_b, -1),
                                            np.full_like(n_b, -E - 2)])
        reads[k] = np.minimum(text[b[:, None], np.clip(
            anchors[k, None] + np.arange(L), 0, n_max - 1)], 4)
        lengths[8 * B : 8 * B + 4] = 0
    perm = rng.permutation(C).astype(np.int32)
    return (text, bin_n, lane_bin, anchors, reads[perm].astype(np.int8),
            np.argsort(perm).astype(np.int32), lengths)
