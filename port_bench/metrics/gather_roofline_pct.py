"""The row-gather kernel's share of its roofline in the traced part of
the window: the bound of the launches kept (core/roofline.py::gather_bound:
distinct rows read, indices and output, at 3.35 TB/s) over the time of their
launches of `row_gather_kernel` in the device trace, in percent.
Nothing to read without a launch."""


def read(rec: dict):
    k = rec["trace"].get("gather")
    if not k or not k["kernels"] or k["kernel_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["kernel_s"]
