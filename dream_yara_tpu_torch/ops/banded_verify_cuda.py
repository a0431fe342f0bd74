"""The banded-verify CUDA kernel (csrc/banded_verify.cu): build, binding and
the one entry point every verification in the port goes through.

`banded_verify` takes the arguments of ops/verify.py::banded_verify, the
stacked-text ones (`lane_bin`, `bin_n`) included. A CPU tensor runs that
plain edition; a CUDA tensor launches the kernel or raises.
The kernel is compiled at first use (ops/nvcc_build.py) and bound with
ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from . import verify as _plain
from .nvcc_build import NvccKernel

MAX_E = 31


class BandedVerifyKernel(NvccKernel):
    """Build-once handle of csrc/banded_verify.cu, with its launch counters:
    `launches` counts both entries, `stacked_launches` the stacked one."""

    def __init__(self):
        super().__init__("banded_verify.cu")
        self.stacked_launches = 0

    def _bind(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dy_banded_verify.argtypes = [
            p, ctypes.c_longlong, p, p, i, i, p, p, i, i, p, p, p, p]
        lib.dy_banded_verify.restype = i
        lib.dy_banded_verify_stacked.argtypes = [
            p, ctypes.c_longlong, i, p, p, p, p, i, i, p, p, i, i, p, p, p, p]
        lib.dy_banded_verify_stacked.restype = i

    def __call__(self, text, anchors, reads, read_rows, lengths, max_err: int,
                 lane_bin=None, bin_n=None):
        """Launch on the current stream of the tensors' device; returns
        (dist, begin, end) (C,) int32 without synchronising. With lane_bin
        and bin_n, `text` is the (B, n_text) stack (stacked entry)."""
        E = int(max_err)
        if not 0 <= E <= MAX_E:
            raise ValueError(f"banded-verify kernel supports 0 <= E <= {MAX_E}, got {E}")
        dev = anchors.device
        if dev.type != "cuda":
            raise ValueError(f"kernel needs CUDA tensors, got {dev}")
        stacked = lane_bin is not None
        if stacked != (bin_n is not None):
            raise ValueError("lane_bin and bin_n go together")
        checks = [("text", text, torch.int8, 2 if stacked else 1),
                  ("anchors", anchors, torch.int32, 1),
                  ("reads", reads, torch.int8, 2),
                  ("read_rows", read_rows, torch.int32, 1),
                  ("lengths", lengths, torch.int32, 1)]
        if stacked:
            checks += [("lane_bin", lane_bin, torch.int32, 1),
                       ("bin_n", bin_n, torch.int32, 1)]
        for name, t, dtype, ndim in checks:
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, anchors on {dev}")
            if t.dtype != dtype or t.dim() != ndim:
                raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, "
                                 f"got {t.dim()}-d {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        C = anchors.shape[0]
        if read_rows.shape[0] != C or lengths.shape[0] != C or (
                stacked and lane_bin.shape[0] != C):
            raise ValueError("anchors, read_rows, lengths and lane_bin differ "
                             "in length")
        if stacked and (text.shape[0] == 0 or bin_n.shape[0] != text.shape[0]):
            raise ValueError(f"bin_n has {bin_n.shape[0]} bins, the text stack "
                             f"{text.shape[0]}")
        R2, L = reads.shape
        lib = self._load()
        dist = torch.empty(C, dtype=torch.int32, device=dev)
        beg = torch.empty_like(dist)
        end = torch.empty_like(dist)
        if C == 0:
            return dist, beg, end
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            tail = (anchors.data_ptr(), reads.data_ptr(), L, R2,
                    read_rows.data_ptr(), lengths.data_ptr(), C, E,
                    dist.data_ptr(), beg.data_ptr(), end.data_ptr(), stream)
            if stacked:
                err = lib.dy_banded_verify_stacked(
                    text.data_ptr(), text.shape[1], text.shape[0],
                    bin_n.data_ptr(), lane_bin.data_ptr(), *tail)
            else:
                err = lib.dy_banded_verify(text.data_ptr(), text.shape[0], *tail)
        self._launched(err)
        if stacked:
            with self._lock:
                self.stacked_launches += 1
        return dist, beg, end


kernel = BandedVerifyKernel()


def banded_verify(text, anchors, reads, read_rows, lengths, max_err: int,
                  lane_bin=None, bin_n=None):
    """The port's verification entry point: the plain edition for CPU
    tensors, the CUDA kernel for CUDA tensors (no fallback between them)."""
    if anchors.device.type == "cpu":
        return _plain.banded_verify(text, anchors, reads, read_rows, lengths,
                                    max_err, lane_bin, bin_n)
    return kernel(text, anchors, reads, read_rows, lengths, max_err,
                  lane_bin, bin_n)
