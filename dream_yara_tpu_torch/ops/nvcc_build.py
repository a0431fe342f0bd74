"""Build and load the port's hand-written CUDA kernels.

Each kernel source in csrc/ exports a plain C entry point, so nvcc builds it
into a shared library in seconds (no PyTorch headers) and ctypes binds it.
A library is compiled at first use for sm_90a into dream_yara_tpu_torch/build/,
named by a hash of its source and flags, so a changed source rebuilds and an
unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin/ on PATH)")
    return nvcc


class NvccKernel:
    """Build-once handle of one kernel library, with its launch counter.

    `launches` grows by one where the kernel is launched and nowhere else,
    so a run can show that its main path went through the kernel.
    Subclasses set the C signature in `_bind` and launch through `_load()`."""

    def __init__(self, source: str):
        self.source = CSRC_DIR / source
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"libdy_{self.source.stem}-{digest}.so"

    def build(self) -> Path:
        """Compile the library unless a build of the same source exists.
        `build_log` holds nvcc's output (the ptxas lines) either way: it is
        kept beside the library."""
        out = self.library_path()
        log = out.with_suffix(".log")
        if out.exists():
            self.build_log = log.read_text() if log.exists() else ""
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{self.build_log}")
        log.write_text(self.build_log)
        os.replace(tmp, out)
        return out

    def _bind(self, lib: ctypes.CDLL) -> None:
        raise NotImplementedError

    def _load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib

    def _launched(self, err: int) -> None:
        """Raise on a non-zero cudaGetLastError after a launch, else count it."""
        if err != 0:
            raise RuntimeError(f"{self.source.stem} kernel launch failed: "
                               f"CUDA error {err}")
        with self._lock:
            self.launches += 1
