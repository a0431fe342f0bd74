"""Path `mesh`: the flat multi-bin step (`--mesh`) over a one-device
`MeshDreamMapper`: classify, route and map all bins in one step on the
card, decode on the host, finish as the default path
(`parallel/dream_mesh.py::mesh_dream_stream`)."""

from __future__ import annotations

from dream_yara_tpu_torch.parallel.dream_mesh import (MeshDreamMapper,
                                                      mesh_dream_stream)
from dream_yara_tpu_torch.utils.options import MapperOptions

from port_bench.core.db import build_index


class Path:
    def __init__(self, names, seqs, cfg, device):
        self.opts = MapperOptions(**cfg["mapper"])
        self.index = build_index(names, seqs, cfg, device)
        self.mapper = MeshDreamMapper(self.index, self.opts)

    def stream(self, batches, timers):
        return mesh_dream_stream(self.mapper, batches, timers=timers,
                                 header=False)

    def counters(self) -> dict:
        return dict(self.mapper.fallback_diag)
