"""The banded-verify kernel's share of its roofline in the traced part of
the window: the bound of the launches kept (core/roofline.py::verify_bound,
from each launch's lane lengths and E) over the time of their launches of
`banded_verify_kernel` in the profiler's device trace, in percent.
Nothing to read without a launch."""


def read(rec: dict):
    k = rec["trace"].get("verify")
    if not k or not k["kernels"] or k["kernel_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["kernel_s"]
