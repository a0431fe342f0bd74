"""dream_yara_tpu_torch — the PyTorch and CUDA port of dream_yara_tpu.

The port sits beside the JAX package and keeps its module names, so each
module here has a counterpart in `dream_yara_tpu/` that its tests hold it
against. It imports `torch` and never `jax`; the reference's JAX-free host
code (index, io, utils, native, golden and the host pipeline stages) is
shared through `_shared`.

Layer map of the first slice (config-1 single-end mapping):
  ops/device_index  — the host FM index moved onto the device
  ops/readpack      — 2-bit read blob packing (host) and unpacking (device)
  ops/rank          — fused rank rows: build (host) and rank queries (device)
  ops/backward_search — exact seed search with the q-mer prefix jump, hit expansion
  ops/verify        — banded verification DP, plain PyTorch edition
  ops/banded_verify_cuda + csrc/banded_verify.cu — the hand-written CUDA kernel
  pipeline/seeding, map_step, mapper, dis_mapper — seeds, the map step,
                      chunking and the DREAM stream

Every entry point takes an explicit `device`; there is no default.
"""

from . import _shared  # noqa: F401 — installs the import boundary first

__version__ = "0.1.0"
