"""The banded-verify CUDA kernel (csrc/banded_verify.cu): build, binding and
the one entry point every verification in the port goes through.

`banded_verify` takes the arguments of ops/verify.py::banded_verify. A CPU
tensor runs that plain edition; a CUDA tensor launches the kernel or raises.
The kernel is compiled at first use with nvcc for sm_90a into
dream_yara_tpu_torch/build/, cached by a hash of the source, and bound with
ctypes (a plain C interface: no PyTorch headers, so the build takes seconds).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import verify as _plain

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "banded_verify.cu"
BUILD_DIR = PKG_DIR / "build"
MAX_E = 31
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the banded-verify kernel cannot be "
                           "built (put the CUDA toolkit's bin/ on PATH)")
    return nvcc


class BandedVerifyKernel:
    """Build-once handle of the kernel library, with its launch counter.

    `launches` grows by one where the kernel is launched and nowhere else,
    so a run can show that its main path went through the kernel."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(SOURCE.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"libdy_banded_verify-{digest}.so"

    def build(self) -> Path:
        """Compile the library unless a build of the same source exists."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{self.build_log}")
        os.replace(tmp, out)
        return out

    def _load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.dy_banded_verify.argtypes = [
                    p, ctypes.c_longlong, p, p, i, i, p, p, i, i, p, p, p, p]
                lib.dy_banded_verify.restype = i
                self._lib = lib
            return self._lib

    def __call__(self, text, anchors, reads, read_rows, lengths, max_err: int):
        """Launch on the current stream of the tensors' device; returns
        (dist, begin, end) (C,) int32 without synchronising."""
        E = int(max_err)
        if not 0 <= E <= MAX_E:
            raise ValueError(f"banded-verify kernel supports 0 <= E <= {MAX_E}, got {E}")
        dev = anchors.device
        if dev.type != "cuda":
            raise ValueError(f"kernel needs CUDA tensors, got {dev}")
        for name, t, dtype, ndim in (("text", text, torch.int8, 1),
                                     ("anchors", anchors, torch.int32, 1),
                                     ("reads", reads, torch.int8, 2),
                                     ("read_rows", read_rows, torch.int32, 1),
                                     ("lengths", lengths, torch.int32, 1)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, anchors on {dev}")
            if t.dtype != dtype or t.dim() != ndim:
                raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, "
                                 f"got {t.dim()}-d {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        C = anchors.shape[0]
        if read_rows.shape[0] != C or lengths.shape[0] != C:
            raise ValueError("anchors, read_rows and lengths differ in length")
        R2, L = reads.shape
        lib = self._load()
        dist = torch.empty(C, dtype=torch.int32, device=dev)
        beg = torch.empty_like(dist)
        end = torch.empty_like(dist)
        if C == 0:
            return dist, beg, end
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.dy_banded_verify(
                text.data_ptr(), text.shape[0], anchors.data_ptr(),
                reads.data_ptr(), L, R2, read_rows.data_ptr(),
                lengths.data_ptr(), C, E, dist.data_ptr(), beg.data_ptr(),
                end.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"banded-verify kernel launch failed: CUDA error {err}")
        with self._lock:
            self.launches += 1
        return dist, beg, end


kernel = BandedVerifyKernel()


def banded_verify(text, anchors, reads, read_rows, lengths, max_err: int):
    """The port's verification entry point: the plain edition for CPU
    tensors, the CUDA kernel for CUDA tensors (no fallback between them)."""
    if anchors.device.type == "cpu":
        return _plain.banded_verify(text, anchors, reads, read_rows, lengths,
                                    max_err)
    return kernel(text, anchors, reads, read_rows, lengths, max_err)
