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

Every port module takes shared host names from here.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
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
from dream_yara_tpu.utils.timer import StageTimers

__all__ = [
    "BLOCK", "BLOCK_WORDS", "DirectKmerFilter", "FMIndex", "GlobalContigs",
    "HASH_SEEDS", "InterleavedBloomFilter", "MIX_MULT", "MapperOptions",
    "Matches", "Ranked", "ReadBatch", "SeqStore", "StageTimers",
    "build_matches", "compute_cigars", "dedup_matches", "golden_map_se",
    "rank_matches", "rescue_candidates", "revcomp", "sam_header",
    "select_pairs", "write_pe_records", "write_se_records",
]
