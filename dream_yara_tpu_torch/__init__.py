"""dream_yara_tpu_torch — the PyTorch and CUDA port of dream_yara_tpu.

The port sits beside the JAX package and keeps its module names, so each
module here has a counterpart in `dream_yara_tpu/` that its tests hold it
against. It imports `torch` and never `jax`, and nothing of `dream_yara_tpu`: the
host code it needs (index, io, utils, native, golden, the host pipeline
stages and the indexer and filter CLIs) is its own copy of the
reference's.

Layer map of the ported slices (config-1 single-end, config-2 DREAM
paired-end with the IBF prefilter, the repeat-rich path: sampled SA and the
repetitive re-seed strata):
  ops/device_index  — the host FM index moved onto the device (sampled-SA
                      fields, reverse rows of the bidirectional index)
  ops/readpack      — 2-bit read blob packing (host) and unpacking (device)
  ops/rank          — fused rank rows: build (host) and rank queries (device)
  ops/backward_search — exact seed search with the q-mer prefix jump, hit expansion
  ops/locate        — the sampled-SA locate (LF walk to marked rows)
  ops/approx_search, ops/bidir_search — approximate seeds of the repetitive
                      strata: layout enumeration, and search schemes on the
                      bidirectional index
  ops/ibf_query     — k-mer hashing, IBF/kdx bin counts and the packed
                      candidate mask of the prefilter
  ops/verify, ops/row_gather — plain PyTorch editions of the two kernels
  ops/banded_verify_cuda + csrc/banded_verify.cu,
  ops/row_gather_cuda + csrc/row_gather.cu — the hand-written CUDA kernels
                      (built by ops/nvcc_build)
  pipeline/seeding, map_step, mapper, dis_mapper — seeds, the map step and
                      the repetitive step, chunking, the overflow and
                      repetitive passes, mate rescue and pairing, routing
                      and the DREAM stream
  index/, io/, utils/, native/, golden/, pipeline/{matches,mapq,cigar,pairs,
  writer}, cli/{indexer,build_filter,update_filter} — host code: the FM
                      index and filters, FASTA/FASTQ/SAM/BAM, options,
                      the C++ helpers (g++ at first use), the golden model
                      and the host tools

Every entry point takes an explicit `device`; there is no default.
"""

__version__ = "0.1.0"
