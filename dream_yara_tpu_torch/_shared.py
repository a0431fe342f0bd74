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
bidirectional sidecar imports no JAX.

Every port module takes shared host names from here.
"""

from __future__ import annotations

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
from dream_yara_tpu.golden.golden_mapper import golden_map_se
from dream_yara_tpu.index import bifm as _bifm
from dream_yara_tpu.index.fmindex import BLOCK, FMIndex
from dream_yara_tpu.index.hashing import BLOCK_WORDS, HASH_SEEDS, MIX_MULT
from dream_yara_tpu.index.ibf import InterleavedBloomFilter
from dream_yara_tpu.index.kdx import DirectKmerFilter
from dream_yara_tpu.io.readstore import ReadBatch
from dream_yara_tpu.io.seqstore import SeqStore
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


def build_reverse_fused(text, tmp_dir: str | None = None):
    """index/bifm.py::build_reverse_fused: (rfused, rcounts) of reverse(text).

    When the reference's ops/rank.py is not loaded, a stand-in module that
    holds only the port's `build_fused_rank_rows` (the same numpy code)
    answers its import for the length of the call. Nothing in the port
    imports that module, so no other import can meet the stand-in."""
    if _RANK in sys.modules:
        return _bifm.build_reverse_fused(text, tmp_dir=tmp_dir)
    from .ops.rank import build_fused_rank_rows

    stand_in = types.ModuleType(_RANK)
    stand_in.build_fused_rank_rows = build_fused_rank_rows
    sys.modules[_RANK] = stand_in
    try:
        return _bifm.build_reverse_fused(text, tmp_dir=tmp_dir)
    finally:
        if sys.modules.get(_RANK) is stand_in:
            del sys.modules[_RANK]


__all__ = [
    "BLOCK", "BLOCK_WORDS", "DirectKmerFilter", "FMIndex", "GlobalContigs",
    "HASH_SEEDS", "InterleavedBloomFilter", "MIX_MULT", "MapperOptions",
    "Matches", "Ranked", "ReadBatch", "SeqStore", "StageTimers",
    "build_matches", "build_reverse_fused", "compute_cigars",
    "dedup_matches", "golden_map_se",
    "rank_matches", "repeat_rich_genome", "rescue_candidates", "revcomp",
    "sample_reads", "sam_header", "select_pairs", "write_pe_records",
    "write_se_records",
]
