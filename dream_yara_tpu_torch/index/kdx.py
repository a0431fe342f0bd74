"""Direct-addressing k-mer filter — exact alternative prefilter.

Analog of reference src/d_kdx_filter.h [U,M] (SURVEY.md §2.7): for small k
(<= 13), a dense table of 4^k rows x one bit per bin — exact k-mer membership,
no false positives. Same which_bins interface as the IBF, selected with
--filter-type kmer_direct. Storage: uint32 (4^k, bins_padded/32), identical
row-gather layout to the IBF so the device query kernel is shared (the "hash"
is the identity on the packed k-mer value).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .hashing import kmer_windows


@dataclass
class DirectKmerFilter:
    bins: int
    k: int
    words: np.ndarray  # (4^k, bins_padded // 32) uint32

    # interface parity with InterleavedBloomFilter
    n_hashes: int = 1
    # marker for the device classify path: rows are the RAW packed k-mer
    # value (identity addressing), not fmix-hashed (ops/ibf_query.py)
    direct = 1

    @property
    def n_rows(self) -> int:
        return self.words.shape[0]

    @property
    def bins_padded(self) -> int:
        return self.words.shape[1] * 32

    @classmethod
    def create(cls, bins: int, k: int = 12):
        if k > 13:
            raise ValueError("direct k-mer filter: k must be <= 13 (4^k table)")
        bins_padded = ((bins + 63) // 64) * 64
        words = np.zeros((4 ** k, bins_padded // 32), dtype=np.uint32)
        return cls(bins=bins, k=k, words=words)

    def add_kmers(self, codes: np.ndarray, bin_id: int):
        lo, _hi, valid = kmer_windows(codes, self.k)  # k<=13 -> fits lo entirely
        if not valid.any():
            return
        rows = lo[valid].astype(np.int64)
        word, bit = divmod(bin_id, 32)
        np.bitwise_or.at(self.words[:, word], rows, np.uint32(1 << bit))

    def clear_bins(self, bin_ids):
        for b in bin_ids:
            word, bit = divmod(int(b), 32)
            self.words[:, word] &= np.uint32(~np.uint32(1 << bit))

    def bin_counts(self, codes: np.ndarray) -> np.ndarray:
        lo, _hi, valid = kmer_windows(codes, self.k)
        counts = np.zeros(self.bins, dtype=np.int32)
        if not valid.any():
            return counts
        row_words = self.words[lo[valid].astype(np.int64)]  # (nk, W)
        shifts = np.arange(32, dtype=np.uint32)
        bits = (row_words[:, :, None] >> shifts) & 1
        return bits.sum(axis=0).reshape(-1)[: self.bins].astype(np.int32)

    def which_bins(self, codes: np.ndarray, threshold: int) -> np.ndarray:
        return np.nonzero(self.bin_counts(codes) >= threshold)[0]

    threshold = staticmethod(
        lambda read_len, k, errors: max(1, (read_len - k + 1) - k * errors))

    def save(self, path):
        np.savez(path, bins=self.bins, k=self.k, words=self.words)

    @classmethod
    def load(cls, path) -> "DirectKmerFilter":
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        z = np.load(path)
        return cls(bins=int(z["bins"]), k=int(z["k"]), words=z["words"])
