"""Banded verification of candidate locations, plain PyTorch edition
(counterpart of dream_yara_tpu/ops/verify.py::banded_verify).

This is the reference the CUDA kernel (csrc/banded_verify.cu) is held to, and
the path a CPU tensor takes. Semantics, shared with the kernel and the golden
model: the edit distance of the ENTIRE read against the text window
[anchor-E, anchor+len+E), with free leading text (semi-global) and band
W = 2E+1. Codes >= 4 (N, sentinel, out-of-text) mismatch everything. On
ties the diagonal beats a read-gap, the in-row insertion is taken only when
strictly better (so the closest origin wins), and the final argmin takes
the smallest diagonal. `begin` is carried through the DP, so there is no
traceback. A lane whose optimum leaves the band reports dist >= INF/2; a
length-0 lane reports (INF, 0, 0).
"""

from __future__ import annotations

import torch

INF = 1 << 20
OUT_OF_TEXT = 6  # the code a window position outside [0, n) reads as


def banded_verify(text: torch.Tensor, anchors: torch.Tensor, reads: torch.Tensor,
                  read_rows: torch.Tensor, lengths: torch.Tensor, max_err: int):
    """Verify candidates (read placed at text position `anchor` +- max_err).

    text: (n,) int8; anchors: (C,) int32 claimed begin positions; reads:
    (R2, L) int8 padded read matrix; read_rows: (C,) int32 row per
    candidate (a row outside [0, R2) reads as all-N); lengths: (C,) int32;
    max_err: band radius E.

    Returns (dist, begin, end): (C,) int32 each (end exclusive)."""
    C = anchors.shape[0]
    R2, L = reads.shape
    n = text.shape[0]
    E = int(max_err)
    W = 2 * E + 1
    dev = anchors.device
    i32 = torch.int32

    row_ok = (read_rows >= 0) & (read_rows < R2)
    reads_g = reads[read_rows.long().clamp(0, max(R2 - 1, 0))]
    reads_g = torch.where(row_ok[:, None], reads_g, 4)
    rT = reads_g.t().to(i32)                                       # (L, C)

    p = ((anchors.long() - E)[:, None]
         + torch.arange(L + 2 * E, device=dev, dtype=torch.int64)[None, :])
    in_text = (p >= 0) & (p < n)
    win = text[p.clamp(0, max(n - 1, 0))] if n > 0 else torch.zeros_like(p)
    wT = torch.where(in_text, win, OUT_OF_TEXT).t().to(i32)       # (L+2E, C)

    d_off = torch.arange(W, device=dev, dtype=i32)[:, None]
    D = torch.zeros((W, C), device=dev, dtype=i32)
    S = d_off.expand(W, C).clone()
    best = torch.full((C,), INF, device=dev, dtype=i32)
    bbeg = torch.zeros(C, device=dev, dtype=i32)
    bend = torch.zeros(C, device=dev, dtype=i32)
    inf_row = torch.full((1, C), INF, device=dev, dtype=i32)
    zero_row = torch.zeros((1, C), device=dev, dtype=i32)
    a0 = anchors - E

    for j in range(L):
        wchars = wT[j : j + W]                                     # (W, C)
        rchar = rT[j : j + 1]                                      # (1, C)
        sub = ((rchar != wchars) | (rchar >= 4) | (wchars >= 4)).to(i32)
        diag = D + sub
        up_D = torch.cat([D[1:], inf_row]) + 1      # read-gap (deletion in read)
        up_S = torch.cat([S[1:], zero_row])
        take_up = up_D < diag
        nD = torch.where(take_up, up_D, diag)
        nS = torch.where(take_up, up_S, S)
        # in-row insertion: nD[d] = min_{d' <= d} nD[d'] + (d - d'), as a
        # min-plus prefix scan by doubling; strict < keeps the closest origin
        k = 1
        while k < W:
            cand = torch.cat([inf_row.expand(k, C), nD[:-k]]) + k
            candS = torch.cat([zero_row.expand(k, C), nS[:-k]])
            take = cand < nD
            nD = torch.where(take, cand, nD)
            nS = torch.where(take, candS, nS)
            k *= 2
        D, S = nD, nS

        done = (j + 1) == lengths
        row_best = nD.min(dim=0).values
        # first (smallest) d reaching the minimum
        d_best = (nD != row_best).to(i32).cumprod(dim=0).sum(dim=0, dtype=i32)
        s_best = nS.gather(0, d_best.long()[None, :])[0]
        best = torch.where(done, row_best, best)
        bbeg = torch.where(done, a0 + s_best, bbeg)
        bend = torch.where(done, a0 + (j + 1) + d_best, bend)
    return best, bbeg, bend
