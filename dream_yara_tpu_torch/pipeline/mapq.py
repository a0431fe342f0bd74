"""Mapping quality — deterministic function of stratum statistics.

Reference analog: getMapq in src/mapper_writer.h [U]. The exact reference
formula could not be verified offline (SURVEY.md §0); this module DEFINES the
contract for this framework (docs/OUTPUT_CONTRACT.md):

    c1 = co-optimal matches (dist == best), c2 = sub-optimal kept matches
    c1 == 1, c2 == 0  -> 40   (unique)
    c1 == 1, c2  > 0  -> 20   (unique best stratum, sub-optimal exist)
    c1 == 2           -> 3    (floor(-10 log10(1 - 1/c1)))
    c1 in {3, 4}      -> 1
    c1 >= 5           -> 0
    unmapped          -> 0
"""

from __future__ import annotations

import numpy as np


def compute_mapq(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    mapq = np.zeros(len(c1), dtype=np.int32)
    unique = c1 == 1
    mapq[unique & (c2 == 0)] = 40
    mapq[unique & (c2 > 0)] = 20
    mapq[c1 == 2] = 3
    mapq[(c1 == 3) | (c1 == 4)] = 1
    return mapq
