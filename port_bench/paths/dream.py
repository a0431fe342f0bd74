"""Path `dream`: the default DREAM mapper. The IBF routes each read to its
candidate bins, each bin's `BinMapper` maps its share on the card, and the
host finishes the batch (`pipeline/dis_mapper.py::dream_map_stream`)."""

from __future__ import annotations

from dream_yara_tpu_torch.pipeline.dis_mapper import dream_map_stream
from dream_yara_tpu_torch.utils.options import MapperOptions

from port_bench.core.db import build_index


class Path:
    def __init__(self, names, seqs, cfg, device):
        self.opts = MapperOptions(**cfg["mapper"])
        self.index = build_index(names, seqs, cfg, device)

    def stream(self, batches, timers):
        return dream_map_stream(self.index, batches, self.opts, timers=timers,
                                header=False)

    def counters(self) -> dict:
        return {}
