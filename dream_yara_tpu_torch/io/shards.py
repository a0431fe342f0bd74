"""Idempotent per-batch output shards — crash-safe mapping runs (SURVEY §5.3).

The reference recovers long runs at file granularity (re-run the failed
invocation); the streaming TPU pipeline maps per-batch, so the natural
checkpoint is one OUTPUT SHARD per input batch:

  <dir>/header.sam            SAM header (written once)
  <dir>/shard_000000.sam      records of batch 0 (no header)
  <dir>/manifest.json         committed shards: reads consumed + record counts

Every shard is written to a tmp file then os.rename'd (atomic on POSIX), and
the manifest is rewritten the same way AFTER the shard lands — a crash
between the two leaves an orphan shard file that is simply overwritten on
retry. Restarting the same command therefore: (1) reads the manifest,
(2) skips `reads_done` input reads, (3) continues appending shards, and
(4) finalize() concatenates header + shards into the requested output —
byte-identical to an uninterrupted run (tests/test_shards.py).
"""

from __future__ import annotations

import json
import os
from pathlib import Path


class ShardedSamWriter:
    def __init__(self, shard_dir: str | os.PathLike):
        self.dir = Path(shard_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._manifest_path = self.dir / "manifest.json"
        if self._manifest_path.exists():
            m = json.loads(self._manifest_path.read_text())
        else:
            m = {"shards": [], "reads_done": 0}
        self.manifest = m

    # --- resume bookkeeping -------------------------------------------------

    @property
    def done_batches(self) -> int:
        return len(self.manifest["shards"])

    @property
    def reads_done(self) -> int:
        return int(self.manifest["reads_done"])

    # --- writing ------------------------------------------------------------

    def _shard_path(self, i: int) -> Path:
        return self.dir / f"shard_{i:06d}.sam"

    def write_header(self, header_text: str) -> None:
        """Idempotent: the header of a resumed run must equal the recorded
        one (same db + contigs), otherwise the shard dir is from a different
        run and resuming would silently mix outputs. @PG is excluded from
        the comparison — it embeds the exact command line, which can differ
        legitimately on resume; the FIRST run's @PG is kept."""
        strip = lambda t: [l for l in t.splitlines() if not l.startswith("@PG")]
        hp = self.dir / "header.sam"
        if hp.exists():
            if strip(hp.read_text()) != strip(header_text):
                raise RuntimeError(
                    f"{hp}: existing header differs — this shard directory "
                    f"belongs to a different database/flag combination; "
                    f"use a fresh --output-shards directory")
            return
        self._atomic_write(hp, header_text)

    def write_batch(self, i: int, records: bytes, n_reads: int) -> bool:
        """Commit batch i's records; returns False if already committed
        (the resume path must then skip the batch's input instead)."""
        if i < self.done_batches:
            return False
        assert i == self.done_batches, \
            f"shards must commit in order (got {i}, expected {self.done_batches})"
        self._atomic_write(self._shard_path(i), records)
        self.manifest["shards"].append({
            "i": i, "reads": int(n_reads),
            "records": sum(1 for l in records.splitlines() if l)})
        self.manifest["reads_done"] = self.reads_done + int(n_reads)
        self._atomic_write(self._manifest_path,
                           json.dumps(self.manifest, indent=1))
        return True

    def _atomic_write(self, path: Path, data: str | bytes) -> None:
        tmp = path.with_suffix(path.suffix + ".tmp")
        if isinstance(data, bytes):
            tmp.write_bytes(data)
        else:
            tmp.write_text(data)
        os.replace(tmp, path)

    # --- finish -------------------------------------------------------------

    def _iter_texts(self):
        yield (self.dir / "header.sam").read_bytes()
        for s in self.manifest["shards"]:
            yield self._shard_path(s["i"]).read_bytes()

    def finalize(self, out_path: str | None = None) -> bytes | None:
        """Assemble header + shards. With out_path, STREAM shard-by-shard to
        that file (BGZF-compressed BAM when it ends with .bam, like the
        direct writer) — never materializing the whole output in memory —
        and return None; else return the full SAM bytes."""
        if out_path is None:
            return b"".join(self._iter_texts())
        tmp = Path(str(out_path) + ".tmp")
        if str(out_path).endswith(".bam"):
            from .bam import BamWriter

            w = BamWriter(open(tmp, "wb"))
            it = self._iter_texts()
            # the BAM header needs @SQ lines: feed header + first shard
            # together, then stream the rest per shard
            w.write_sam(next(it) + next(it, b""))
            for text in it:
                w.write_sam(text)
            w.close()
        else:
            with open(tmp, "wb") as f:
                for text in self._iter_texts():
                    f.write(text)
        os.replace(tmp, out_path)
        return None


def drive_sharded_stream(reader, shard_dir, header_text, make_stream,
                         out_path) -> str | None:
    """Shared CLI driver for --output-shards (both the single-device and
    mesh mapper branches): resume past committed shards, map the remaining
    batches through `make_stream(batches) -> iter of header-free SAM texts`
    (order-preserving; may pipeline internally), commit each as a shard,
    then finalize into out_path. Returns the full SAM bytes when out_path
    is '-'/empty (caller prints), else None."""
    sw = ShardedSamWriter(shard_dir)
    sw.write_header(header_text)
    batches = skip_reads(reader, sw.reads_done)
    sizes: list[int] = []

    def sized():
        for b in batches:
            sizes.append(b.n_reads)
            yield b

    shard_i = sw.done_batches
    for sam in make_stream(sized()):
        # streams run ahead of consumption (dispatch-ahead); pop(0) is the
        # oldest un-committed batch = the one this sam belongs to
        sw.write_batch(shard_i, sam, sizes.pop(0))
        shard_i += 1
    if out_path and out_path != "-":
        sw.finalize(out_path)
        return None
    return sw.finalize(None)


def skip_reads(reader, n_skip: int):
    """Fast-forward a batch iterator past already-committed input reads.

    Batch sizes are deterministic (same -rb flag on resume), so committed
    work always aligns to whole batches; a mismatch means the flags changed
    and we refuse rather than emit overlapping or missing records."""
    skipped = 0
    it = iter(reader)
    while skipped < n_skip:
        try:
            b = next(it)
        except StopIteration:
            raise RuntimeError(
                f"resume mismatch: manifest says {n_skip} reads are already "
                f"committed but the input contains only {skipped}; this is "
                f"not the original run's input file") from None
        skipped += b.n_reads
        if skipped > n_skip:
            raise RuntimeError(
                f"resume mismatch: manifest says {n_skip} reads done but "
                f"batch boundaries land at {skipped}; rerun with the same "
                f"-rb/--reads-batch as the original run")
    return it
