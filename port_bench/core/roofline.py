"""The least time the card could take for one launch of each of the port's
two kernels: frozen copies of the port's formulas, kept with the
benchmark so that a change to the program cannot move its own yardstick.

Peaks are the published ones of one NVIDIA H100 SXM (NVIDIA's data
sheet): 3.35 TB/s of HBM and 67 T 32-bit operations a second outside the
tensor cores.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12


def verify_bound(lengths: np.ndarray, E: int, stacked: bool):
    """(seconds, bound by, bytes, operations) of one banded-verify launch
    (`dream_yara_tpu_torch/verify_bench.py::bound`): read characters and
    window characters of every valid lane read once, lane fields read and
    outputs written once; six integer operations a DP cell."""
    valid = lengths[lengths > 0].astype(np.int64)
    C = len(lengths)
    nbytes = int(valid.sum() * 2 + len(valid) * 2 * E
                 + C * (16 if stacked else 12) + C * 12)
    ops = int(valid.sum()) * (2 * E + 1) * 6
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def gather_bound(distinct_rows: int, width_words: int, n_idx: int,
                 idx_bytes: int):
    """(seconds, bytes) of one row-gather launch: every distinct row read
    once, the indices read once and the output written once."""
    row = 4 * width_words
    nbytes = distinct_rows * row + n_idx * idx_bytes + n_idx * row
    return nbytes / HBM_BYTES_PER_S, nbytes
