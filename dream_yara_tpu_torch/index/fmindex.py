"""FM-index over one bin's concatenated contig text.

Analog of reference SeqAn FMIndex with YaraFMConfig (SURVEY.md §2.4 [U]):
2-bit-packed rank dictionary + sampled SA in the reference. TPU-first layout
here (designed for batched gathers, the device-side hot loop in
ops/backward_search.py):

  * BWT stored as dense int8 *blocks* of BLOCK=128 chars: shape
    (n_blocks, 128). A rank query gathers exactly one row (128 B) — the
    natural TPU lane width and within one HBM transaction.
  * Occ checkpoints every BLOCK chars: int32 (n_blocks+1, SIGMA).
    rank_c(i) = occ[i>>7, c] + popcount(bwt_block[i>>7][0 : i&127] == c).
  * C table: int32 (SIGMA+1,) cumulative symbol counts of the text.
  * SA: int32. sample_rate=1 stores the full SA (locate = one gather —
    speed-of-light; the default while a bin fits HBM). sample_rate=s>1 stores
    SA values at text positions divisible by s plus a marked-row bitmap;
    locate walks <=s-1 LF steps (fixed-trip-count on device).

The FM text alphabet is SIGMA=6 (A,C,G,T,N,$): N is a literal 6th symbol (a
seed containing N only matches text N; verification later re-scores N as
mismatching everything, see docs/OUTPUT_CONTRACT.md), and $ (SENTINEL)
separates contigs so matches cannot span contig boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.alphabet import SIGMA
from .suffix_array import build_suffix_array

BLOCK = 128
BWT_PAD = 7  # padding code in the last BWT block; != any real symbol


@dataclass
class FMIndex:
    n: int                     # text length
    bwt_blocks: np.ndarray     # (n_blocks, BLOCK) int8, padded with BWT_PAD
    occ: np.ndarray            # (n_blocks + 1, SIGMA) int32 checkpoint counts
    counts: np.ndarray         # (SIGMA + 1,) int32 cumulative C table
    sa: np.ndarray             # full SA (sample_rate=1) or sampled values
    sample_rate: int = 1
    # sampled mode: packed mark bitmap + rank checkpoints, the SAME layout
    # the device uses (ops/device_index.py) — ~n/6 bytes total. The old
    # dense host arrays (uint8 marks + int32 prefix counts) cost 5n bytes
    # per bin on disk AND in RAM, which dominated Gbp-scale artifacts.
    sa_mark_bits: np.ndarray | None = None  # (ceil(n/32) pad4,) uint32
    sa_rank_ck: np.ndarray | None = None    # (ceil(n/128)+1,) int32
    # q-mer prefix lookup (classic FM speedup): interval of every ACGT q-mer,
    # i.e. the state after q backward-search steps — one table gather replaces
    # q rank-query iterations on the device.
    prefix_q: int = 0
    pfx_lo: np.ndarray | None = None     # (4^q,) int32
    pfx_hi: np.ndarray | None = None     # (4^q,) int32

    @classmethod
    def build(cls, text: np.ndarray, sample_rate: int = 1,
              sa: np.ndarray | None = None,
              tmp_dir: str | None = None,
              prefix_q: int | None = None) -> "FMIndex":
        """tmp_dir: external-memory SA construction (reference indexer
        `--tmp-dir`, SURVEY.md §2.1 [U]) — the SA lives in an OS-paged
        memmap under tmp_dir instead of RAM. prefix_q caps the q-mer
        prefix-table depth (table HBM = 2*4^q ints/bin; big-B databases
        trade a couple of extra rank trips for table memory)."""
        text = np.asarray(text, dtype=np.int8)
        n = len(text)
        if n >= (1 << 31):
            raise ValueError(
                f"bin of {n} bp exceeds the int32 index ceiling (2^31-1 "
                f"~ 2.1 Gbp per bin): split it into smaller bins — the "
                f"DREAM design point — e.g. per chromosome for GRCh38")
        if sa is None:
            sa = build_suffix_array(text, tmp_dir=tmp_dir)
        sa = np.asarray(sa, dtype=np.int32)

        # chunked BWT + occ build: the obvious one-liners materialize
        # O(n)-scale temporaries (sa-1 int32, a (n_blocks, 128, SIGMA)
        # one-hot) that dominate peak RSS at Gbp scale — chunking bounds
        # the transient working set to ~0.5 GB regardless of n
        n_blocks = (n + BLOCK - 1) // BLOCK
        padded = np.full(n_blocks * BLOCK, BWT_PAD, dtype=np.int8)
        CH = 1 << 26
        for c0 in range(0, n, CH):
            sc = sa[c0 : c0 + CH]
            padded[c0 : c0 + len(sc)] = np.where(sc > 0, text[sc - 1],
                                                 text[n - 1])
        bwt_blocks = padded.reshape(n_blocks, BLOCK)

        # occ[b, c] = count of c in bwt[0 : b*BLOCK]
        codes = np.arange(SIGMA, dtype=np.int8)
        per_block = np.empty((n_blocks, SIGMA), dtype=np.int32)
        BCH = 1 << 19
        for b0 in range(0, n_blocks, BCH):
            blk = bwt_blocks[b0 : b0 + BCH]
            per_block[b0 : b0 + len(blk)] = (blk[:, :, None] == codes).sum(
                axis=1, dtype=np.int32)
        occ = np.zeros((n_blocks + 1, SIGMA), dtype=np.int32)
        np.cumsum(per_block, axis=0, out=occ[1:])

        # C table from the occ totals: the BWT is a permutation of the text,
        # so per-symbol text counts == occ[n_blocks] (the bincount one-liner
        # cast text to int64 — an 8n-byte spike that DOMINATED build RSS)
        counts = np.zeros(SIGMA + 1, dtype=np.int32)
        np.cumsum(occ[n_blocks], out=counts[1:])

        fm = cls(n=n, bwt_blocks=bwt_blocks, occ=occ, counts=counts,
                 sa=sa, sample_rate=1)
        fm.build_prefix_table(text, prefix_q)
        if sample_rate > 1:
            fm = fm.subsample_sa(sample_rate)
        return fm

    def build_prefix_table(self, text: np.ndarray, q: int | None = None):
        """Intervals of all ACGT q-mers, derived in O(n) from the sorted SA.

        Suffix keys = base-6 value of the first q chars (pad-A past the text
        end; every short suffix contains the terminal sentinel digit inside
        its window, so padding never collides with a pure-ACGT key). Keys are
        non-decreasing in SA order, so each q-mer's interval is a
        searchsorted pair. q defaults to ~log4(n) (table ~ text size),
        capped at 11 so keys fit int32 (6^11 < 2^31) — GRCh38-scale bins
        would otherwise burn ~3x the text size in int64 temporaries. Keys
        are built in SA chunks to bound peak memory at ~5 bytes/char.
        """
        n = self.n
        if q is None:
            q = max(2, min(11, int(np.log(max(n, 16)) / np.log(4))))
        q = min(q, 11)
        if self.sample_rate > 1:
            # `self.sa` holds only the SAMPLED values here, so the
            # SA-order key scan below would read a 1/rate subset and emit
            # a corrupt table (found via a mixed-prefix_q DeviceFMSet
            # rebuild: bins default to size-dependent q, and the stacked
            # set rebuilds every bin at the common min q). Derive the
            # intervals from the BWT instead — no SA required.
            self._build_prefix_table_bwt(q)
            return
        tpad = np.concatenate([np.asarray(text, np.int8),
                               np.zeros(q, np.int8)])   # int8: codes fit
        idx = np.arange(4 ** q, dtype=np.int64)
        key6 = np.zeros(4 ** q, dtype=np.int32)
        for t in range(q):
            key6 = key6 * np.int32(6) + ((idx >> (2 * (q - 1 - t))) & 3).astype(np.int32)
        # keys are non-decreasing in SA order, so the global searchsorted
        # index of each q-mer is the SUM of per-chunk searchsorted indices —
        # the full (n,) int32 key array (4 GB at 1 Gbp) never materializes
        lo = np.zeros(4 ** q, dtype=np.int64)
        hi = np.zeros(4 ** q, dtype=np.int64)
        CHUNK = 1 << 24
        for c0 in range(0, n, CHUNK):
            sa_c = self.sa[c0 : c0 + CHUNK].astype(np.int64)
            kc = np.zeros(len(sa_c), dtype=np.int32)
            for t in range(q):
                kc = kc * np.int32(6) + tpad[sa_c + t]
            lo += np.searchsorted(kc, key6, side="left")
            hi += np.searchsorted(kc, key6, side="right")
        self.prefix_q = q
        self.pfx_lo = lo.astype(np.int32)
        self.pfx_hi = hi.astype(np.int32)

    def _rank_np(self, c: int, i: np.ndarray) -> np.ndarray:
        """Vectorized host rank_c(i) over the BWT blocks (i in [0, n])."""
        b = i >> 7
        r = (i & 127).astype(np.int32)
        blk = self.bwt_blocks[np.minimum(b, self.bwt_blocks.shape[0] - 1)]
        within = ((blk == c)
                  & (np.arange(BLOCK, dtype=np.int32)[None, :] < r[:, None])
                  ).sum(axis=1, dtype=np.int32)
        return self.occ[b, c] + within

    def _build_prefix_table_bwt(self, q: int):
        """q-mer intervals by backward-extension BFS over the BWT.

        Depth-d table entry m (a d-mer, first char most significant) is the
        backward-search interval of that d-mer; it extends the (d-1)-table
        entry of its SUFFIX m mod 4^(d-1) by its first char c = m >> 2(d-1):
        lo' = C[c] + rank_c(lo). Identical semantics to the SA key scan
        (suffixes whose first d chars equal the d-mer; suffixes with N/$
        inside the window are never counted because only A..T extend).
        2 * sum_d 4^d rank queries total, no SA access."""
        lo = np.array([0], dtype=np.int64)
        hi = np.array([self.n], dtype=np.int64)
        for d in range(1, q + 1):
            m = len(lo)
            nlo = np.empty(4 * m, dtype=np.int64)
            nhi = np.empty(4 * m, dtype=np.int64)
            for c in range(4):
                base = np.int64(self.counts[c])
                nlo[c * m : (c + 1) * m] = base + self._rank_np(c, lo)
                nhi[c * m : (c + 1) * m] = base + self._rank_np(c, hi)
            lo, hi = nlo, nhi
        self.prefix_q = q
        self.pfx_lo = lo.astype(np.int32)
        self.pfx_hi = hi.astype(np.int32)

    def subsample_sa(self, rate: int) -> "FMIndex":
        """Keep SA values at text positions % rate == 0; see ops/locate.py.

        Rows whose BWT char is a sentinel are ALSO marked: LF through a
        repeated sentinel is not order-consistent (SA-IS places
        sentinel-starting suffixes by terminator convention, not by what
        follows them), so the locate walk must stop before taking that step.
        Multiples of `rate` all stay marked, so the walk's <= rate-1 trip
        bound is unchanged; the extra samples cost one int32 + one mark bit
        per contig boundary.
        """
        n = self.n
        nw = ((n + 31) // 32 + 3) // 4 * 4      # 4-word groups (device DMA)
        nck = (n + 127) // 128
        mark_bits = np.zeros(nw, dtype=np.uint32)
        rank_ck = np.zeros(nck + 1, dtype=np.int32)
        from ..utils.alphabet import SENTINEL
        n_sent = int(self.counts[SENTINEL + 1] - self.counts[SENTINEL])
        samples = np.empty((n + rate - 1) // rate + n_sent, dtype=np.int32)
        bwt_flat = self.bwt_blocks.reshape(-1)
        shifts = np.arange(32, dtype=np.uint32)
        CH = 1 << 25                            # multiple of 128 and 32
        done = 0
        for c0 in range(0, n, CH):
            sc = self.sa[c0 : c0 + CH]
            m = (sc % rate == 0) | (bwt_flat[c0 : c0 + len(sc)] == SENTINEL)
            k = int(m.sum())
            samples[done : done + k] = sc[m]
            done += k
            pad = np.zeros(((len(m) + 31) // 32) * 32, dtype=bool)
            pad[: len(m)] = m
            w = pad.reshape(-1, 32)
            mark_bits[c0 // 32 : c0 // 32 + len(w)] = (
                w.astype(np.uint32) << shifts[None, :]).sum(
                    axis=1, dtype=np.uint32)
            per = np.zeros(((len(m) + 127) // 128) * 128, dtype=bool)
            per[: len(m)] = m
            rank_ck[c0 // 128 + 1 : c0 // 128 + 1 + len(per) // 128] = (
                per.reshape(-1, 128).sum(axis=1, dtype=np.int32))
        np.cumsum(rank_ck, out=rank_ck)
        assert done <= len(samples), (done, len(samples))
        return FMIndex(
            n=n, bwt_blocks=self.bwt_blocks, occ=self.occ,
            counts=self.counts, sa=samples[:done].copy(), sample_rate=rate,
            sa_mark_bits=mark_bits, sa_rank_ck=rank_ck,
            prefix_q=self.prefix_q, pfx_lo=self.pfx_lo, pfx_hi=self.pfx_hi,
        )

    # --- host-side reference rank/search (oracle for device kernels) ---

    def rank(self, c: int, i: int) -> int:
        """Occurrences of c in bwt[0:i)."""
        b, r = divmod(i, BLOCK)
        if r == 0:
            # i == n on a 128-divisible text lands b == n_blocks: the occ
            # checkpoint row exists but there is no BWT block to scan
            return int(self.occ[b, c])
        return int(self.occ[b, c]) + int((self.bwt_blocks[b, :r] == c).sum())

    def backward_step(self, c: int, lo: int, hi: int) -> tuple[int, int]:
        return (int(self.counts[c]) + self.rank(c, lo),
                int(self.counts[c]) + self.rank(c, hi))

    def backward_search(self, pattern: np.ndarray) -> tuple[int, int]:
        """SA interval [lo, hi) of exact occurrences of pattern (searched back-to-front)."""
        lo, hi = 0, self.n
        for c in np.asarray(pattern, dtype=np.int8)[::-1]:
            lo, hi = self.backward_step(int(c), lo, hi)
            if lo >= hi:
                return lo, lo
        return lo, hi

    def _mark(self, row: int) -> bool:
        return bool((int(self.sa_mark_bits[row >> 5]) >> (row & 31)) & 1)

    def _mark_rank(self, row: int) -> int:
        """Number of marked rows before `row` (checkpoint + partial words)."""
        ck = int(self.sa_rank_ck[row >> 7])
        w0 = (row >> 7) << 2                    # first word of the 128-block
        for w in range(w0, row >> 5):
            ck += int(self.sa_mark_bits[w]).bit_count()
        tail = row & 31
        if tail:
            ck += int(int(self.sa_mark_bits[row >> 5])
                      & ((1 << tail) - 1)).bit_count()
        return ck

    def locate(self, row: int) -> int:
        """Text position of SA row (host oracle; device version in ops/locate.py)."""
        if self.sample_rate == 1:
            return int(self.sa[row])
        steps = 0
        while not self._mark(row):
            b, r = divmod(row, BLOCK)
            c = int(self.bwt_blocks[b, r])
            row = int(self.counts[c]) + self.rank(c, row)
            steps += 1
        return int(self.sa[self._mark_rank(row)]) + steps

    # --- serialization (per-bin artifact, SURVEY.md §5.4) ---

    def save(self, path):
        extra = {}
        if self.sample_rate > 1:
            extra.update(sa_mark_bits=self.sa_mark_bits,
                         sa_rank_ck=self.sa_rank_ck)
        if self.prefix_q:
            extra.update(prefix_q=self.prefix_q, pfx_lo=self.pfx_lo,
                         pfx_hi=self.pfx_hi)
        np.savez(
            path, n=self.n, bwt_blocks=self.bwt_blocks, occ=self.occ,
            counts=self.counts, sa=self.sa, sample_rate=self.sample_rate,
            **extra)

    @classmethod
    def load(cls, path) -> "FMIndex":
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        z = np.load(path)
        rate = int(z["sample_rate"])
        has_pfx = "prefix_q" in z.files
        mark_bits = rank_ck = None
        if rate > 1:
            if "sa_mark_bits" in z.files:
                mark_bits, rank_ck = z["sa_mark_bits"], z["sa_rank_ck"]
            else:
                # legacy artifact with dense uint8 marks + int32 prefix
                # counts: pack on load
                marked = z["sa_marked"].astype(bool)
                n = int(z["n"])
                nw = ((n + 31) // 32 + 3) // 4 * 4
                pad = np.zeros(nw * 32, dtype=bool)
                pad[:n] = marked
                mark_bits = (pad.reshape(nw, 32).astype(np.uint32)
                             << np.arange(32, dtype=np.uint32)[None, :]).sum(
                                 axis=1, dtype=np.uint32)
                nck = (n + 127) // 128
                per = pad[: nck * 128].reshape(nck, 128).sum(axis=1)
                rank_ck = np.zeros(nck + 1, dtype=np.int32)
                np.cumsum(per, out=rank_ck[1:])
        return cls(n=int(z["n"]), bwt_blocks=z["bwt_blocks"], occ=z["occ"],
                   counts=z["counts"], sa=z["sa"], sample_rate=rate,
                   sa_mark_bits=mark_bits, sa_rank_ck=rank_ck,
                   prefix_q=int(z["prefix_q"]) if has_pfx else 0,
                   pfx_lo=z["pfx_lo"] if has_pfx else None,
                   pfx_hi=z["pfx_hi"] if has_pfx else None)
