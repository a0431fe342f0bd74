"""Build the native C++ libraries with g++ (no external deps).

Each library is compiled into dream_yara_tpu_torch/build/native/, named by a
hash of its sources and flags, so a changed source rebuilds and a library
built from other sources is never loaded.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

HERE = Path(__file__).parent
BUILD_DIR = HERE.parent / "build" / "native"
FLAGS = ["-O3", "-march=native", "-std=c++17", "-fopenmp", "-shared", "-fPIC"]
LIBS = {
    "libdyalign.so": ["align.cpp"],
    "libdysais.so": ["sais.cpp"],
    "libdysamfmt.so": ["samfmt.cpp"],
    "libdyscatter.so": ["scatter.cpp"],
    "libdyseqio.so": ["seqio.cpp"],
    "libdyreadpack.so": ["readpack.cpp"],
}


def library_path(name: str) -> Path:
    """Where `name` is built: its stem and a hash of its sources and flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in LIBS[name]:
        h.update((HERE / s).read_bytes())
    return BUILD_DIR / f"{Path(name).stem}-{h.hexdigest()[:16]}.so"


def build(name: str, quiet: bool = True) -> Path | None:
    srcs = [HERE / s for s in LIBS[name]]
    if not all(s.exists() for s in srcs):
        return None
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = ["g++", *FLAGS, *[str(s) for s in srcs], "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=quiet)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"[native] build of {name} failed: {e}", file=sys.stderr)
        return None
    os.replace(tmp, out)
    return out


def main():
    for name in LIBS:
        p = build(name, quiet=False)
        print(f"[native] {name}: {'built -> ' + str(p) if p else 'SKIPPED'}")


if __name__ == "__main__":
    main()
