"""The card's idle share of the traced span: 100 x (1 - the union of its
kernel, copy and set intervals / the span). Nothing to read without a
device trace."""


def read(rec: dict):
    t = rec["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
