"""dream-yara-tpu-torch-mapper — map reads against a DREAM database with the
PyTorch/CUDA port (counterpart of dream_yara_tpu/cli/mapper_cli.py).

It takes the reference mapper's arguments, and writes the same bytes for
them: the @PG CL field records the argument list. The device comes from
DY_PLATFORM (cli/common.py::cli_device): the CUDA card by default, `cpu`
for the CPU. --mesh maps with the flat multi-bin step
(parallel/dream_mesh.py) on that one device; the multi-host flags wait for
the multi-GPU edition (ROADMAP item 16).
"""

from __future__ import annotations

import argparse
import sys
import time

from .common import cli_guard


@cli_guard
def main(argv=None):
    p = argparse.ArgumentParser(
        prog="dream-yara-tpu-torch-mapper",
        description="DREAM read mapper, PyTorch/CUDA port (SE or PE).")
    p.add_argument("db_dir", help="database directory from the indexer")
    p.add_argument("reads", help="FASTQ (optionally .gz)")
    p.add_argument("reads2", nargs="?", default=None, help="mate FASTQ (PE mode)")
    p.add_argument("-o", "--output-file", default="-")
    p.add_argument("-e", "--error-rate", type=float, default=0.05,
                   help="max errors as fraction of read length")
    p.add_argument("-s", "--strata-count", type=int, default=0)
    p.add_argument("-y", "--sensitivity", default="high",
                   choices=["low", "high", "full"])
    p.add_argument("-rg", "--read-group", default="",
                   help="@RG ID; per-record RG:Z tag when set")
    p.add_argument("-sm", "--secondary-matches", default="tag",
                   choices=["tag", "record", "omit"])
    p.add_argument("-i", "--indels", default="on", choices=["on", "off"])
    p.add_argument("-ll", "--library-length", type=int, default=200)
    p.add_argument("-ld", "--library-deviation", type=int, default=100)
    p.add_argument("--no-rescue", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-rb", "--reads-batch", type=int, default=100_000)
    p.add_argument("-ft", "--filter-type", default="bloom",
                   choices=["bloom", "kmer_direct", "none"])
    p.add_argument("--output-shards", default=None, metavar="DIR",
                   help="crash-safe mode: one SAM shard per batch in DIR "
                        "(atomic rename + manifest); re-running the same "
                        "command resumes after the last committed shard, "
                        "then assembles -o from the shards")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--mesh", action="store_true",
                   help="map with the flat multi-bin step (one device)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host runs: not in the port yet")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    a = p.parse_args(argv)
    if (a.coordinator, a.num_processes, a.process_id) != (None, None, None):
        sys.exit("error: multi-host mapping (--coordinator, --num-processes, "
                 "--process-id) is not in the port yet: ROADMAP item 16")

    from ..io.fastq import FastqBatchReader
    from ..io.shards import drive_sharded_stream
    from ..pipeline.dis_mapper import DreamIndex, dream_map_stream
    from ..pipeline.writer import sam_header
    from ..utils.options import MapperOptions
    from ..utils.timer import StageTimers
    from .common import cli_device, open_output

    device = cli_device()
    opts = MapperOptions(
        error_rate=a.error_rate, strata_count=a.strata_count,
        sensitivity=a.sensitivity, secondary_matches=a.secondary_matches,
        indels=a.indels == "on", library_length=a.library_length,
        library_deviation=a.library_deviation, rescue=not a.no_rescue,
        threads=a.threads, reads_batch=a.reads_batch,
        filter_type=a.filter_type, output_file=a.output_file,
        read_group=a.read_group, verbose=a.verbose)
    cmdline = " ".join(argv if argv is not None else sys.argv[1:])

    t0 = time.time()
    timers = StageTimers()
    index = DreamIndex.load(a.db_dir, filter_type=a.filter_type, device=device)
    timers.add("load index", time.time() - t0)
    if a.mesh:
        from ..parallel.dream_mesh import MeshDreamMapper, mesh_dream_stream

        mapper = MeshDreamMapper(index, opts)
        stream = lambda bs, **kw: mesh_dream_stream(mapper, bs, timers=timers,
                                                    stats=stats, **kw)
        label = f"[mapper mesh={mapper.mesh_shape}]"
    else:
        stream = lambda bs, **kw: dream_map_stream(index, bs, opts, timers=timers,
                                                   stats=stats, **kw)
        label = "[mapper]"

    reader = FastqBatchReader(a.reads, a.reads2, batch_size=a.reads_batch)
    stats: dict = {}
    t0 = time.time()
    if a.output_shards:
        text = drive_sharded_stream(
            reader, a.output_shards,
            "\n".join(sam_header(index.contigs, cmdline,
                                 read_group=opts.read_group or None)) + "\n",
            lambda bs: stream(bs, header=False), a.output_file)
        if text is not None:
            sys.stdout.buffer.write(text)
    else:
        out = open_output(a.output_file)
        try:
            for i, sam in enumerate(stream(reader, cmdline=cmdline)):
                out.write_sam(sam)
                if a.verbose:
                    rate = stats.get("reads", 0) / (time.time() - t0)
                    print(f"{label} batch {i} done ({rate:.0f} reads/s cum)",
                          file=sys.stderr)
        finally:
            out.close()
    dt = time.time() - t0
    n_reads = stats.get("reads", 0)
    print(f"{label} {n_reads} reads in {dt:.1f}s "
          f"({n_reads / max(dt, 1e-9):.0f} reads/s) on {device}", file=sys.stderr)
    if n_reads:
        mapped, unique = stats.get("mapped", 0), stats.get("unique", 0)
        line = (f"{label} mapped: {mapped} ({100.0 * mapped / n_reads:.2f}%)  "
                f"unique: {unique} ({100.0 * unique / n_reads:.2f}%)")
        if "proper_pairs" in stats:
            pp = stats["proper_pairs"]
            line += f"  proper pairs: {pp} ({200.0 * pp / n_reads:.2f}%)"
        print(line, file=sys.stderr)
    if a.verbose:
        print(timers.report(), file=sys.stderr)


if __name__ == "__main__":
    main()
