"""The deployment's real database, built in process from the generated
sequences with the port's own index code: an FM index a bin
(`index/fmindex.py`) and the prefilter (`index/ibf.py`). Nothing is
written to disk."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dream_yara_tpu_torch.index.fmindex import FMIndex
from dream_yara_tpu_torch.index.ibf import InterleavedBloomFilter
from dream_yara_tpu_torch.io.seqstore import SeqStore
from dream_yara_tpu_torch.pipeline.dis_mapper import DreamIndex


def build_index(names: list[str], seqs: list[np.ndarray], cfg: dict,
                device: torch.device) -> DreamIndex:
    """One contig a bin. `cfg["index"]`: sample_rate; `cfg["filter"]`:
    kind (ibf), size_bits (or bits_per_bp x bin length x bins padded to
    64), n_hashes, k, canonical, blocked."""
    stores = [SeqStore.from_seqs([n], [s]) for n, s in zip(names, seqs)]
    rate = int(cfg["index"]["sample_rate"])
    workers = min(len(stores), os.cpu_count() or 1)
    fms = [FMIndex.build(stores[0].text, sample_rate=rate)]   # builds the native code once
    with ThreadPoolExecutor(max_workers=workers) as ex:
        fms += list(ex.map(lambda st: FMIndex.build(st.text, sample_rate=rate),
                           stores[1:]))
    f = cfg["filter"]
    bins = len(seqs)
    size = f.get("size_bits")
    if size is None:
        size = int(f["bits_per_bp"] * max(len(s) for s in seqs)
                   * (((bins + 63) // 64) * 64))
    ibf = InterleavedBloomFilter.create(bins, size_bits=int(size),
                                        n_hashes=int(f["n_hashes"]), k=int(f["k"]),
                                        canonical=bool(f["canonical"]),
                                        blocked=bool(f["blocked"]))
    # bins of one 32-bit word go in one thread: threads never share a word
    groups: dict[int, list[int]] = {}
    for b in range(bins):
        groups.setdefault(b // 32, []).append(b)

    def insert(bs):
        for b in bs:
            ibf.add_kmers(seqs[b], b)

    with ThreadPoolExecutor(max_workers=min(len(groups), workers)) as ex:
        list(ex.map(insert, groups.values()))
    return DreamIndex(stores, fms, ibf, f["kind"], device=device)
