"""The port's one door into the reference package's JAX-free host code.

The port shares the reference's host modules (index/, io/, utils/, native/,
golden/ and pipeline/{matches,mapq,cigar,pairs,writer}.py) instead of copying
them. They import only numpy, but `dream_yara_tpu/pipeline/__init__.py`
eagerly imports `.mapper`, which imports `jax.numpy`, so on a host without
JAX even `import dream_yara_tpu.pipeline.writer` would fail.

`_install_pipeline_package` registers `dream_yara_tpu.pipeline` as a bare
package module (same `__path__`, its `__init__` not run) when nothing has
imported it yet. Its PEP 562 `__getattr__` serves the names the real
`__init__` exports on first use, so JAX code that runs later in the same
process still finds `BinMapper`, `map_single_bin` and the rest. A lazy
`pipeline/__init__.py` in the reference would make this shim unnecessary
(ROADMAP, Queue 1).

`build_reverse_fused` (index/bifm.py) takes `build_fused_rank_rows` from
the reference's ops/rank.py, a JAX module; where that module is not loaded,
the call lends it the port's numpy copy (ops/rank.py), so building a
bidirectional sidecar imports no JAX. `run_indexer` runs the shared indexer
CLI the same way: it takes `bin_file` from the reference's
pipeline/dis_mapper.py, and is lent the port's. `run_build_filter` runs the
shared build-filter CLI, which imports only host modules.

Every port module takes shared host names from here.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import sys
import types
from pathlib import Path

import dream_yara_tpu

_PIPELINE = "dream_yara_tpu.pipeline"

# names `dream_yara_tpu/pipeline/__init__.py` exports -> defining submodule
_PIPELINE_EXPORTS = {
    "BinMapper": "mapper", "map_single_bin": "mapper",
    "single_bin_sam": "mapper",
    "Matches": "matches", "Ranked": "matches", "build_matches": "matches",
    "dedup_matches": "matches", "rank_matches": "matches",
    "compute_mapq": "mapq",
    "compute_cigars": "cigar",
    "GlobalContigs": "writer", "sam_header": "writer",
    "write_se_records": "writer",
}


def _install_pipeline_package() -> None:
    if _PIPELINE in sys.modules:
        return
    pkg_dir = Path(dream_yara_tpu.__file__).parent / "pipeline"
    spec = importlib.util.spec_from_file_location(
        _PIPELINE, pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)])
    mod = importlib.util.module_from_spec(spec)

    def __getattr__(name: str):
        sub = _PIPELINE_EXPORTS.get(name)
        if sub is None:
            raise AttributeError(f"module {_PIPELINE!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(f"{_PIPELINE}.{sub}"), name)
        setattr(mod, name, value)
        return value

    mod.__getattr__ = __getattr__
    sys.modules[_PIPELINE] = mod
    dream_yara_tpu.pipeline = mod


_install_pipeline_package()

# ruff: noqa: E402 — the imports below need the package installed above
from dream_yara_tpu.cli.common import cli_guard, open_output
from dream_yara_tpu.golden.golden_mapper import golden_map_se
from dream_yara_tpu.index import bifm as _bifm
from dream_yara_tpu.index.fmindex import BLOCK, BWT_PAD, FMIndex
from dream_yara_tpu.index.hashing import BLOCK_WORDS, HASH_SEEDS, MIX_MULT
from dream_yara_tpu.index.ibf import InterleavedBloomFilter
from dream_yara_tpu.index.kdx import DirectKmerFilter
from dream_yara_tpu.io.fasta import write_fasta
from dream_yara_tpu.io.fastq import FastqBatchReader
from dream_yara_tpu.io.readstore import ReadBatch
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.io.shards import drive_sharded_stream
from dream_yara_tpu.pipeline.cigar import compute_cigars
from dream_yara_tpu.pipeline.matches import (Matches, Ranked, build_matches,
                                             dedup_matches, rank_matches)
from dream_yara_tpu.pipeline.pairs import rescue_candidates, select_pairs
from dream_yara_tpu.pipeline.writer import (GlobalContigs, sam_header,
                                            write_pe_records, write_se_records)
from dream_yara_tpu.utils.alphabet import revcomp
from dream_yara_tpu.utils.options import MapperOptions
from dream_yara_tpu.utils.simulate import repeat_rich_genome, sample_reads
from dream_yara_tpu.utils.timer import StageTimers

_RANK = "dream_yara_tpu.ops.rank"
_DIS_MAPPER = "dream_yara_tpu.pipeline.dis_mapper"


@contextlib.contextmanager
def _lent(name: str, **attrs):
    """While the reference's JAX module `name` is not loaded, a stand-in
    module holding only `attrs` answers its import. Nothing in the port
    imports those modules, so no other import can meet the stand-in."""
    if name in sys.modules:
        yield
        return
    stand_in = types.ModuleType(name)
    stand_in.__dict__.update(attrs)
    sys.modules[name] = stand_in
    try:
        yield
    finally:
        if sys.modules.get(name) is stand_in:
            del sys.modules[name]


def build_reverse_fused(text, tmp_dir: str | None = None):
    """index/bifm.py::build_reverse_fused: (rfused, rcounts) of reverse(text),
    lent the port's numpy `build_fused_rank_rows`."""
    from .ops.rank import build_fused_rank_rows

    with _lent(_RANK, build_fused_rank_rows=build_fused_rank_rows):
        return _bifm.build_reverse_fused(text, tmp_dir=tmp_dir)


def run_indexer(argv: list[str]) -> None:
    """The shared indexer CLI (dream-yara-tpu-indexer) without JAX: it is
    lent the port's `bin_file` (same paths) and `build_fused_rank_rows`."""
    from dream_yara_tpu.cli import indexer

    from .ops.rank import build_fused_rank_rows
    from .pipeline.dis_mapper import bin_file

    with _lent(_DIS_MAPPER, bin_file=bin_file), \
            _lent(_RANK, build_fused_rank_rows=build_fused_rank_rows):
        indexer.main(argv)


def run_build_filter(argv: list[str]) -> None:
    """The shared build-filter CLI (dream-yara-tpu-build-filter)."""
    from dream_yara_tpu.cli import build_filter

    build_filter.main(argv)


__all__ = [
    "BLOCK", "BLOCK_WORDS", "BWT_PAD", "DirectKmerFilter", "FMIndex",
    "FastqBatchReader", "GlobalContigs", "HASH_SEEDS",
    "InterleavedBloomFilter", "MIX_MULT", "MapperOptions", "Matches",
    "Ranked", "ReadBatch", "SeqStore", "StageTimers",
    "build_matches", "build_reverse_fused", "cli_guard", "compute_cigars",
    "dedup_matches", "drive_sharded_stream", "golden_map_se", "open_output",
    "rank_matches", "repeat_rich_genome", "rescue_candidates", "revcomp",
    "run_build_filter", "run_indexer", "sample_reads", "sam_header",
    "select_pairs", "write_fasta", "write_pe_records", "write_se_records",
]
