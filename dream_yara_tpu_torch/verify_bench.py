"""Time the banded-verify kernel on one CUDA card, at the shapes chip_smoke.py
checks and at one shape for each other band bucket, against its plain
edition and, optionally, against other editions of csrc/banded_verify.cu
(an earlier commit's source, or a variant of it) with the same C interface:

    python -m dream_yara_tpu_torch.verify_bench [--edition NAME=PATH ...] [--out FILE]

Every edition must equal the plain edition exactly at every shape (the
outputs are integers). Times come from CUDA events over REPS launches,
taken in turns (each edition, then again in reverse order), with the card's
name and power limit, its clocks during the timing and the host's CPU
beside them, and the bound of each timed shape. Prints one JSON object an
edition build (nvcc seconds, ptxas registers and spills) and one a shape,
and writes them all to --out.

The shapes, the bound and the timing helpers are also chip_smoke.py's.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPS = 20
# (C, L, E, edges): the single-bin entry's shapes; those without edges are timed
SHAPES = ((131_072, 100, 3, False), (131_072, 150, 4, False),
          (8_192, 250, 12, False), (4_096, 100, 3, True),
          (4_096, 150, 4, True), (4_096, 250, 12, True),
          (2_048, 120, 31, True), (2_048, 60, 0, True))
# timed here only: one shape for each band bucket the shapes above leave
# out (W_MAX = 13, 17, 33, 63, each band filling its bucket)
BUCKET_SHAPES = ((131_072, 150, 6, False), (131_072, 150, 8, False),
                 (8_192, 250, 16, False), (8_192, 250, 31, False))
GENOME_LEN = 4_600_000
# (what, bin lengths, C, L, E, edges): the stacked entry's shapes; the first
# is config-5's (256 bins of 400,000 bp, the verify lanes of a 50,000-read
# batch: cap2v = 1.25 x its pool), the others edge layouts of unequal bins
STACKED_SHAPES = (
    ("config-5", (400_001,) * 256, 78_125, 100, 3, False),
    ("edges, unequal bins", tuple(2000 + 128 * b + 7 * (b % 3) for b in range(5)),
     4_096, 100, 3, True),
    ("edges, L=150 E=4", (3000, 1000, 2500), 4_096, 150, 4, True))


def _smi(query: str) -> subprocess.CompletedProcess:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    return _smi("name,power.limit").stdout.strip().splitlines()[0]


def host_line() -> str:
    """The first card's clocks now and at most, and the host's CPU model:
    what a time taken on this machine depends on beside the power limit."""
    clocks = _smi("clocks.sm,clocks.mem,clocks.max.sm,clocks.max.mem")
    cpu = f"{platform.machine()} {platform.processor()}".strip()
    cpuinfo = Path("/proc/cpuinfo")
    if cpuinfo.exists():   # the first processor's fields (a VM may hide its model name)
        first = cpuinfo.read_text().split("\n\n")[0]
        fields = dict(ln.split(":", 1) for ln in first.splitlines() if ":" in ln)
        fields = {k.strip(): v.strip() for k, v in fields.items()}
        cpu = ", ".join(f"{k} {fields[k]}" for k in
                        ("vendor_id", "cpu family", "model", "model name", "cpu MHz")
                        if k in fields) or cpu
    return (f"clocks.sm, clocks.mem, clocks.max.sm, clocks.max.mem: "
            f"{clocks.stdout.strip().splitlines()[0]}; host CPU: {cpu}, "
            f"{len(os.sched_getaffinity(0))} usable cores")


class ClockSampler:
    """Samples the first card's SM and memory clocks (MHz) every 100 ms
    while the block runs, from an `nvidia-smi -lms` child process that is
    stopped on exit. `summary()` gives min / median / max of each."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem",
             "--format=csv,noheader,nounits", "-i", "0", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.samples = [tuple(int(v) for v in ln.split(","))
                        for ln in out.splitlines() if re.fullmatch(r"\s*\d+,\s*\d+\s*", ln)]
        return False

    def summary(self) -> str:
        if not self.samples:
            return "clocks: no sample"
        sm, mem = (np.asarray(v) for v in zip(*self.samples))
        return (f"clocks.sm {sm.min()} / {int(np.median(sm))} / {sm.max()} MHz, "
                f"clocks.mem {mem.min()} / {int(np.median(mem))} / {mem.max()} MHz "
                f"(min / median / max of {len(sm)} samples)")


def time_ms(fn, reps: int) -> float:
    """Mean ms of `reps` calls of fn on the current stream (CUDA events),
    after one untimed call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def editions(specs):
    """{name: kernel}: this source as built by the port, and each
    NAME=PATH built by nvcc with the port's flags."""
    from .ops.banded_verify_cuda import BandedVerifyKernel, kernel

    out = {"port": kernel}
    for spec in specs:
        name, _, path = spec.partition("=")
        out[name] = BandedVerifyKernel()
        out[name].source = Path(path)
    return out


def ptxas_summary(log: str) -> list[str]:
    """One line a kernel instance of `nvcc -Xptxas -v`: its template
    arguments, registers, shared memory and spills."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"kernelI(\w+?)EEv", ln)
        if "Compiling entry" in ln and m:
            name = m.group(1)
        elif "spill" in ln and name:
            spills = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spills}")
            name = None
    return out


def bound(lengths, E: int, stacked: bool):
    """(bound_ms, bound_by, bytes, ops) of one call at these lengths: read
    chars and window chars of every valid lane read once, lane fields read
    and outputs written once; six integer operations a DP cell at the
    67 T op/s of the card's non-tensor 32-bit rate; 3.35 TB/s."""
    valid = lengths[lengths > 0].astype(np.int64)
    C = len(lengths)
    nbytes = int(valid.sum() * 2 + len(valid) * 2 * E + C * (16 if stacked else 12) + C * 12)
    ops = int(valid.sum()) * (2 * E + 1) * 6
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, ops / 67e12 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--edition", action="append", default=[])
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("verify_bench: no CUDA device", file=sys.stderr)
        return 2
    from .ops import verify
    from .verify_cases import edge_case, stacked_case, verify_case

    card = card_line()
    print(card, flush=True)
    print(host_line(), flush=True)
    kernels = editions(a.edition)
    builds = []
    for name, k in kernels.items():
        t0 = time.perf_counter()
        k.build()
        builds.append({"edition": name, "source": str(k.source),
                       "nvcc_s": time.perf_counter() - t0,
                       "ptxas": ptxas_summary(k.build_log)})
        print(json.dumps(builds[-1]), flush=True)
    dev = torch.device("cuda")
    rows = []
    text_np = np.random.default_rng(12345).integers(0, 4, GENOME_LEN).astype(np.int8)
    text_np[::9973] = 4
    text = torch.from_numpy(text_np).to(dev)
    rng = np.random.default_rng(7)
    cases = []
    for C, L, E, edges in SHAPES + BUCKET_SHAPES:
        case = verify_case(rng, text_np, C, L, E)
        if edges:
            case = edge_case(text_np, *case)
        cases.append((f"C={C} L={L} E={E}" + (" edges" if edges else ""), E, False,
                      (text, *(torch.from_numpy(x).to(dev) for x in case)), {},
                      case[3], not edges))
    rng = np.random.default_rng(5)
    for what, lens, C, L, E, edges in STACKED_SHAPES:
        host = stacked_case(rng, lens, C, L, E, edges)
        t, bin_n, lane_bin, *rest = (torch.from_numpy(x).to(dev) for x in host)
        cases.append((f"stacked {what}", E, True, (t, *rest),
                      dict(lane_bin=lane_bin, bin_n=bin_n), host[6], not edges))
    with ClockSampler() as clocks:
        for what, E, stacked, args, kw, lengths, timed in cases:
            want = verify.banded_verify(*args, E, **kw)
            row = {"shape": what, "card": card, "equal": {}}
            for name, k in kernels.items():
                got = k(*args, E, **kw)
                torch.cuda.synchronize()
                row["equal"][name] = all(torch.equal(g, w) for g, w in zip(got, want))
            if timed:
                names = list(kernels)
                ms = {n: [] for n in names}
                for order in (names, names[::-1]):
                    for n in order:
                        ms[n].append(time_ms(lambda: kernels[n](*args, E, **kw), REPS))
                row["ms"] = ms
                row["plain_ms"] = time_ms(lambda: verify.banded_verify(*args, E, **kw), 2)
                b_ms, b_by, nbytes, ops = bound(np.asarray(lengths), E, stacked)
                row.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
                           share={n: b_ms / min(v) for n, v in ms.items()})
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(f"[timing] {clocks.summary()}", flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({"card": card, "clocks": clocks.summary(),
                                           "editions": builds, "shapes": rows},
                                          indent=1))
    bad = [(r["shape"], n) for r in rows for n, ok in r["equal"].items() if not ok]
    if bad:
        print(f"verify_bench: editions differ from the plain edition: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
