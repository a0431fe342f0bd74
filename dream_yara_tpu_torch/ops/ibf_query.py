"""Device IBF query: per-bin k-mer counts, routing thresholds and the packed
candidate mask of a read chunk (counterpart of
dream_yara_tpu/ops/ibf_query.py).

All four filter modes of the reference are here: the blocked layout (all
probes of a k-mer in one 128-word block; the default for new filters and
the card's path), the classic layout (one scattered row per hash), direct
addressing (kdx: the row is the packed k-mer) and minimizer winnowing
(w > k: only window minimizers are counted, compacted per read first).

torch has no full uint32 arithmetic, so hash values live in int64 tensors
holding uint32 values: multiplies are split into 16-bit halves
(`_mul32`) and every result is masked to 32 bits, which gives the
wrap-around of the reference's uint32 math bit for bit. Filter words sit on
the device as int32 with bit 31 live; a shift is always followed by a mask.

The block-row fetch of the blocked mode goes through the row-gather kernel
(ops/row_gather_cuda.py). The reference's one-hot probe select exists for
TPU gather costs; here `torch.gather` along the block picks the same words.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..index.hashing import BLOCK_WORDS, HASH_SEEDS, MIX_MULT
from .readpack import int32_bits, unpack_blob, unpack_fwd, unpack_reads
from .row_gather_cuda import gather_rows

_U32 = 0xFFFFFFFF
LANE_BUDGET_WORDS = 1 << 28  # gathered block-row words per chunk (~1 GiB)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32): each partial product
    stays below 2^49, so nothing overflows int64."""
    c = int(c) & _U32
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def kmer_windows_dev(reads: torch.Tensor, lengths: torch.Tensor, k: int,
                     canonical: bool = False):
    """Packed k-mer windows of each read row. reads: (R, L) int8.

    Returns (lo, hi, valid): (R, L-k+1) each, lo/hi int64 holding uint32;
    valid masks windows with N/pad or beyond the read length.
    `canonical=True` gives the strand-canonical min(fwd, revcomp) packing."""
    R, L = reads.shape
    m = L - k + 1
    codes = reads.long() & 3
    lo = torch.zeros((R, m), dtype=torch.int64, device=reads.device)
    hi = torch.zeros_like(lo)
    for t in range(min(k, 16)):
        lo |= codes[:, t : m + t] << (2 * t)
    for t in range(16, k):
        hi |= codes[:, t : m + t] << (2 * (t - 16))
    if canonical:
        comp = 3 - codes
        lo_r = torch.zeros_like(lo)
        hi_r = torch.zeros_like(lo)
        for t in range(min(k, 16)):
            lo_r |= comp[:, k - 1 - t : k - 1 - t + m] << (2 * t)
        for t in range(16, k):
            hi_r |= comp[:, k - 1 - t : k - 1 - t + m] << (2 * (t - 16))
        # values are non-negative int64, so signed order is unsigned order
        swap = (hi_r < hi) | ((hi_r == hi) & (lo_r < lo))
        lo = torch.where(swap, lo_r, lo)
        hi = torch.where(swap, hi_r, hi)
    bad = (reads >= 4).to(torch.int32)
    cbad = F.pad(torch.cumsum(bad, dim=1, dtype=torch.int32), (1, 0))
    no_n = (cbad[:, k:] - cbad[:, :-k]) == 0
    pos_ok = (torch.arange(m, device=reads.device)[None, :] + k) <= lengths[:, None]
    return lo, hi, no_n & pos_ok


def minimizer_select_dev(mix: torch.Tensor, valid: torch.Tensor,
                         lengths: torch.Tensor, w: int, k: int) -> torch.Tensor:
    """Winnowing, bit-identical to index/hashing.minimizer_select: a
    position is selected iff it is the strict leftmost minimum of
    key = fmix32(mix) in some w-window of the read; reads shorter than w
    have one window (window 0)."""
    R, m = mix.shape
    W0 = w - k + 1
    if W0 <= 1:
        return valid
    dev = mix.device
    key = torch.where(valid, _fmix32(mix), _U32)
    n_win = m - W0 + 1
    if n_win <= 0:
        n_win = 1
        key = F.pad(key, (0, W0 - m), value=_U32)
    n_win_r = torch.clamp(lengths - w + 1, min=1)[:, None]
    win = torch.arange(n_win, device=dev, dtype=torch.int32)[None, :]
    bk = key[:, :n_win]
    bp = win.expand(R, n_win)
    for d in range(1, W0):
        kd = key[:, d : d + n_win]
        better = kd < bk
        bk = torch.where(better, kd, bk)
        bp = torch.where(better, win + d, bp)
    pos = torch.arange(m, device=dev, dtype=torch.int32)[None, :]
    jpad = F.pad(bp, (0, max(m - n_win, 0)), value=-1)[:, :m]
    last = torch.clamp(n_win_r, max=n_win)
    sel = torch.zeros((R, m), dtype=torch.bool, device=dev)
    for d in range(W0):
        shifted = torch.roll(jpad, d, dims=1)
        sel |= (shifted == pos) & (pos - d >= 0) & (pos - d < last)
    return sel & valid


def host_block_rows(words, n_bins: int = 0):
    """Host-side block-row layout: keep the counted words of each row and
    reshape (n_rows, Wd) -> (n_blocks, S * wdc), with S = 128 / Wd probe
    rows per block. Returns (rows, S)."""
    words = np.asarray(words)
    n_rows, Wd = words.shape
    S = BLOCK_WORDS // Wd
    wdc = min(Wd, max(1, (n_bins + 31) // 32)) if n_bins > 0 else Wd
    n_blocks = n_rows // S
    rows = np.ascontiguousarray(words[:, :wdc]).reshape(n_blocks, S * wdc)
    return rows, S


def _count_rows_blocked(filter_words, mixf, lanes_valid, n_hashes: int,
                        wd_count: int | None = None, block_s: int = 0):
    """Blocked-layout counts: one block row per window (the row-gather
    kernel on a card), the n_hashes probe words picked from it, AND-ed and
    unpacked to per-bin counts. Row ids are block * S + p_j, bit-identical
    to index/hashing.ibf_blocked_rows.

    block_s > 0: filter_words already has the (n_blocks, S * wdc) layout
    of host_block_rows; else it is (n_rows, Wd) and is reshaped here.
    The window axis runs in chunks of reads so that the gathered rows stay
    within LANE_BUDGET_WORDS words. Returns (R, wdc, 32) int32."""
    if block_s > 0:
        S = block_s
        n_blocks, sw = filter_words.shape
        wdc = sw // S
        rows = filter_words
    else:
        n_rows, Wd = filter_words.shape
        S = BLOCK_WORDS // Wd
        n_blocks = n_rows // S
        wdc = Wd if wd_count is None else min(wd_count, Wd)
        rows = filter_words[:, :wdc] if wdc < Wd else filter_words
        rows = rows.reshape(n_blocks, S * wdc).contiguous()
    R, M = lanes_valid.shape
    dev = lanes_valid.device
    c = max(1, min(R, (LANE_BUDGET_WORDS // (S * wdc)) // max(M, 1)))
    mix2 = mixf.reshape(R, M)
    shifts = torch.arange(32, device=dev, dtype=torch.int32)
    counts = []
    for r0 in range(0, R, c):
        mf = mix2[r0 : r0 + c].reshape(-1)
        vc = lanes_valid[r0 : r0 + c]
        v0 = _fmix32(mf ^ int(HASH_SEEDS[0]))
        block = (v0 & 0x7FFFFFFF) % n_blocks
        v1 = _fmix32(mf ^ int(HASH_SEEDS[1]))
        base = v1 & (S - 1)
        stride = ((v1 >> 8) & (S - 1)) | 1
        br = gather_rows(rows, block).view(-1, S, wdc)      # (c*M, S, wdc)
        anded = None
        for j in range(n_hashes):
            pj = (base + j * stride) & (S - 1)
            gw = br.gather(1, pj[:, None, None].expand(-1, 1, wdc))[:, 0]
            anded = gw if anded is None else anded & gw
        anded = torch.where(vc.reshape(-1)[:, None], anded, 0)
        bits = (anded[:, :, None] >> shifts) & 1
        counts.append(bits.reshape(vc.shape[0], M, wdc * 32)
                      .sum(dim=1, dtype=torch.int32))
    return torch.cat(counts).reshape(R, wdc, 32)


def _count_rows(filter_words, rows_by_hash, lanes_valid):
    """Classic layout: AND the hash rows' words per lane and unpack them to
    per-bin counts. rows_by_hash: per-hash flat (R*M,) row ids.
    Returns (R, Wd, 32) int32."""
    R, M = lanes_valid.shape
    vflat = lanes_valid.reshape(-1)
    shifts = torch.arange(32, device=lanes_valid.device, dtype=torch.int32)
    outs = []
    for w in range(filter_words.shape[1]):
        col = filter_words[:, w]
        anded = None
        for rj in rows_by_hash:
            gw = col[rj]
            anded = gw if anded is None else anded & gw
        anded = torch.where(vflat, anded, 0).reshape(R, M)
        bits = (anded[:, :, None] >> shifts) & 1
        outs.append(bits.sum(dim=1, dtype=torch.int32))
    return torch.stack(outs, dim=1)


def ibf_bin_counts(filter_words: torch.Tensor, reads: torch.Tensor,
                   lengths: torch.Tensor, k: int, n_hashes: int,
                   window: int = 0, canonical: bool = False,
                   blocked: bool = False, direct: bool = False,
                   n_bins: int = 0, block_s: int = 0):
    """Per-bin (selected-)k-mer hit counts of each read row.

    filter_words: (n_rows, Wd) int32 filter words, or the host_block_rows
    layout when block_s > 0; reads: (R, L) int8. Returns (counts, n_sel):
    counts (R, Wc*32) int32 over padded bins, n_sel (R,) int32 the number
    of counted k-mers. n_bins > 0 restricts blocked counting to the words
    that hold real bins."""
    n_rows = filter_words.shape[0]
    R = reads.shape[0]
    lo, hi, valid = kmer_windows_dev(reads, lengths, k, canonical=canonical)
    mix = lo ^ _mul32(hi, int(MIX_MULT))
    if window > k:
        valid = minimizer_select_dev(mix, valid, lengths, window, k)
        # compact the selected k-mers of each read before the row fetches
        m = mix.shape[1]
        W0 = window - k + 1
        cap = max(8, (2 * m) // max(W0, 1) + 8)
        pos = torch.cumsum(valid.to(torch.int32), dim=1) - 1
        dst = torch.where(valid & (pos < cap), pos, cap).long()
        z = torch.zeros((R, cap + 1), dtype=torch.int64, device=mix.device)
        z.scatter_(1, dst, torch.where(valid, mix, 0))
        total = torch.clamp(pos[:, -1] + 1, max=cap)
        lanes_valid = (torch.arange(cap, device=mix.device)[None, :]
                       < total[:, None])
        mix, valid, n_sel = z[:, :cap], lanes_valid, total
    else:
        n_sel = valid.sum(dim=1, dtype=torch.int32)
    mixf = mix.reshape(-1)
    if blocked:
        wd_count = (None if block_s > 0 else
                    (min(filter_words.shape[1], max(1, (n_bins + 31) // 32))
                     if n_bins > 0 else None))
        counts = _count_rows_blocked(filter_words, mixf, valid, n_hashes,
                                     wd_count, block_s=block_s)
        return counts.reshape(R, -1), n_sel
    if direct:
        # kdx: the row is the packed k-mer itself (k <= 13, so hi == 0)
        counts = _count_rows(filter_words, [mixf], valid)
        return counts.reshape(R, -1), n_sel
    rows_by_hash = [(_fmix32(mixf ^ int(HASH_SEEDS[j])) & 0x7FFFFFFF) % n_rows
                    for j in range(n_hashes)]
    counts = _count_rows(filter_words, rows_by_hash, valid)
    return counts.reshape(R, -1), n_sel


def classify_thresholds(lengths2, n_sel, k: int, window: int, rate_ppm: int,
                        slack_table=None):
    """Per-row routing threshold: the k-mer lemma, or in minimizer mode
    n_sel minus the calibrated slack (extrapolated past the table's last
    entry by the heuristic's per-error step), else the 2D heuristic."""
    e = (lengths2.long() * rate_ppm) // 10_000
    if window > k:
        W0 = max(window - k + 1, 1)
        D = -(-k // W0) + 2
        if slack_table is not None:
            e_max = slack_table.shape[0] - 1
            slack = (slack_table.long()[e.clamp(0, e_max)]
                     + torch.clamp(e - e_max, min=0) * 2 * D)
            return torch.clamp(n_sel - slack, min=1)
        return torch.clamp(n_sel - e * 2 * D, min=1)
    return torch.clamp((lengths2 - k + 1) - k * e, min=1)


def routing_from_counts(counts, n_sel, lengths2, k: int, window: int,
                        rate_ppm: int, half: int, slack_table=None):
    """Candidate mask of (fwd | rc) rows' counts: each row against its
    threshold, then the OR of a read's two orientations. (half, Bp) bool."""
    thr = classify_thresholds(lengths2, n_sel, k, window, rate_ppm,
                              slack_table)
    mask = counts >= thr[:, None]
    return mask[:half] | mask[half:]


def ibf_candidates(filter_words, reads, lengths, slack_table=None, *,
                   half: int, k: int, n_hashes: int, rate_ppm: int,
                   window: int = 0, canonical: bool = False,
                   blocked: bool = False, direct: bool = False,
                   n_bins: int = 0, block_s: int = 0) -> torch.Tensor:
    """(half, Bp) candidate mask of `half` reads: count (selected) k-mers
    per bin and threshold. reads: the [fwd | rc] rows; a canonical filter
    counts the forward rows only (they answer both orientations), so
    `reads` may then hold just those."""
    if canonical:
        counts, n_sel = ibf_bin_counts(filter_words, reads[:half], lengths, k,
                                       n_hashes, window, canonical=True,
                                       blocked=blocked, n_bins=n_bins,
                                       block_s=block_s)
        thr = classify_thresholds(lengths, n_sel, k, window, rate_ppm,
                                  slack_table)
        return counts >= thr[:, None]
    lengths2 = torch.cat([lengths, lengths])
    counts, n_sel = ibf_bin_counts(filter_words, reads, lengths2, k, n_hashes,
                                   window, blocked=blocked, direct=direct,
                                   n_bins=n_bins, block_s=block_s)
    return routing_from_counts(counts, n_sel, lengths2, k, window, rate_ppm,
                               half, slack_table)


def ibf_classify_packed(filter_words, blob, slack_table=None, *, half: int,
                        L: int, canonical: bool = False, **kw) -> torch.Tensor:
    """Candidate mask of a chunk from its packed read blob (held as int32),
    bit-packed: (half, Bp/32) int32 words with the reference's uint32 bits.
    kw: ibf_candidates' filter parameters."""
    packed, nmask, lengths = unpack_blob(blob, half, L)
    unpack = unpack_fwd if canonical else unpack_reads
    reads = unpack(packed, nmask, lengths, L)
    return pack_mask_bits(ibf_candidates(filter_words, reads, lengths,
                                         slack_table, half=half,
                                         canonical=canonical, **kw))


def pack_mask_bits(cand: torch.Tensor) -> torch.Tensor:
    """(n, B) bool -> (n, ceil(B/32)) int32 words holding the uint32 bits,
    bin j at bit j % 32 of word j // 32."""
    n, B = cand.shape
    w = (B + 31) // 32
    bits = F.pad(cand, (0, w * 32 - B)).reshape(n, w, 32).long()
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return int32_bits((bits << shifts).sum(dim=2))
