"""Read-matrix packing (counterpart of dream_yara_tpu/ops/readpack.py).

Host side: forward read rows are packed at 2 bits a base plus an N bitmask,
with the lengths appended, into one uint32 blob — the format both packages
share, so the parity tests feed the same blob to each. Device side: the blob
is split and unpacked into int8 rows, and the reverse-complement rows are
rebuilt from the forward ones.

The device holds the blob as int32 (torch supports uint32 only partly). Bit
31 is live in both the 2-bit codes (word position 15) and the N mask, so
every right shift is followed by a mask.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_reads_fwd(seqs_fwd: np.ndarray, half: int, L: int,
                   packed_out: np.ndarray | None = None,
                   nmask_out: np.ndarray | None = None):
    """Host-side: 2-bit-pack forward read rows + N bitmask (uint32 outputs).

    Uses the port's native packer (native/readpack.cpp) and
    falls back to the numpy oracle below when it cannot be built, exactly as
    the reference does; packed_out/nmask_out let callers pack straight into
    a blob slice."""
    k = seqs_fwd.shape[0]
    Wp = (L + 15) // 16
    Wn = (L + 31) // 32
    from ..native import readpack as _native

    if _native.available():
        if packed_out is None:
            packed_out = np.empty((half, Wp), dtype=np.uint32)
        if nmask_out is None:
            nmask_out = np.empty((half, Wn), dtype=np.uint32)
        _native.pack_reads(seqs_fwd, half, L, packed_out, nmask_out)
        return packed_out, nmask_out
    codes = np.zeros((half, Wp * 16), dtype=np.uint32)
    isn = np.zeros((half, Wn * 32), dtype=np.uint32)
    codes[:k, :L] = (seqs_fwd & 3).astype(np.uint32)
    isn[:k, :L] = (seqs_fwd >= 4).astype(np.uint32)
    isn[k:, :] = 1
    isn[:, L:] = 1
    sh2 = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    packed = (codes.reshape(half, Wp, 16) << sh2).sum(axis=2, dtype=np.uint32)
    sh1 = np.arange(32, dtype=np.uint32)[None, None, :]
    nmask = (isn.reshape(half, Wn, 32) << sh1).sum(axis=2, dtype=np.uint32)
    if packed_out is not None:
        packed_out[:] = packed
        packed = packed_out
    if nmask_out is not None:
        nmask_out[:] = nmask
        nmask = nmask_out
    return packed, nmask


def pack_blob_with_lengths(seqs_fwd: np.ndarray, lengths: np.ndarray,
                           half: int, L: int) -> np.ndarray:
    """One contiguous uint32 upload: [packed | nmask | lengths-as-uint32]."""
    Wp = (L + 15) // 16
    Wn = (L + 31) // 32
    nl = len(lengths)
    blob = np.empty(half * (Wp + Wn) + nl, dtype=np.uint32)
    pack_reads_fwd(seqs_fwd, half, L,
                   packed_out=blob[: half * Wp].reshape(half, Wp),
                   nmask_out=blob[half * Wp : half * (Wp + Wn)].reshape(half, Wn))
    blob[half * (Wp + Wn) :] = lengths.astype(np.int32).view(np.uint32)
    return blob


def int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 bit pattern -> the int32 with the same bits."""
    v = v & 0xFFFFFFFF
    return (v - ((v >> 31) << 32)).to(torch.int32)


def unpack_blob(blob: torch.Tensor, half: int, L: int):
    """Device-side split of a blob held as int32: (packed, nmask, lengths)."""
    Wp = (L + 15) // 16
    Wn = (L + 31) // 32
    packed = blob[: half * Wp].reshape(half, Wp)
    nmask = blob[half * Wp : half * (Wp + Wn)].reshape(half, Wn)
    lengths = blob[half * (Wp + Wn) :]
    return packed, nmask, lengths


def unpack_fwd(packed: torch.Tensor, nmask: torch.Tensor,
               lengths: torch.Tensor, L: int) -> torch.Tensor:
    """Forward rows: (half, L) int8, pads and N = 4."""
    half = packed.shape[0]
    dev = packed.device
    sh2 = (torch.arange(16, device=dev, dtype=torch.int32) * 2)[None, None, :]
    chars = ((packed[:, :, None] >> sh2) & 3).reshape(half, -1)[:, :L]
    sh1 = torch.arange(32, device=dev, dtype=torch.int32)[None, None, :]
    isn = ((nmask[:, :, None] >> sh1) & 1).reshape(half, -1)[:, :L]
    j = torch.arange(L, device=dev, dtype=torch.int32)[None, :]
    return torch.where((isn == 1) | (j >= lengths[:, None]), 4,
                       chars).to(torch.int8)


def unpack_reads(packed: torch.Tensor, nmask: torch.Tensor,
                 lengths: torch.Tensor, L: int) -> torch.Tensor:
    """Device-side inverse of pack_reads_fwd: (2 * half, L) int8 rows
    [fwd | revcomp], the ReadBatch layout (pads = N)."""
    fwd = unpack_fwd(packed, nmask, lengths, L)
    dev = fwd.device
    j = torch.arange(L, device=dev, dtype=torch.int64)[None, :]
    # rc row: complement(reverse(fwd)), rolled left by (L - len), pads N
    flip = fwd.flip(1)
    compf = torch.where(flip < 4, 3 - flip, flip)
    shift = (L - lengths).long()[:, None]
    rolled = compf.gather(1, (j + shift) % L)
    rc = torch.where(j < lengths[:, None], rolled, 4).to(torch.int8)
    return torch.cat([fwd, rc], dim=0)
