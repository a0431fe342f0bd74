"""Shared CLI helpers of the port (counterpart of
dream_yara_tpu/cli/common.py). `cli_guard` and `open_output` are the
reference's, shared through `_shared`; the device choice is the port's."""

from __future__ import annotations

import os

import torch

from .._shared import cli_guard, open_output

__all__ = ["cli_device", "cli_guard", "open_output"]


def cli_device() -> torch.device:
    """The device the CLI maps on, from DY_PLATFORM (the reference's
    platform override, so both CLIs take the same arguments): unset or
    `cuda` is the CUDA card, `cpu` the CPU; anything else is an error, and
    so is `cuda` without a card. There is no fallback between the two."""
    plat = os.environ.get("DY_PLATFORM", "") or "cuda"
    if plat == "cpu":
        return torch.device("cpu")
    if plat != "cuda":
        raise ValueError(f"DY_PLATFORM={plat!r}: the port maps on 'cuda' "
                         f"(the default) or 'cpu'")
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device (set DY_PLATFORM=cpu to map on the CPU)")
    return torch.device("cuda")
