"""Stream time (the card's waits on the host included) of the repetitive
re-seed groups: the seconds between the CUDA events of the spans
"repetitive stratum 1 (device time)" and "repetitive stratum 2 (device
time)", one span a group, per million reads of the batches whose device
time was taken ("device-timed reads"). None where no batch was timed."""

SPANS = ("repetitive stratum 1 (device time)",
         "repetitive stratum 2 (device time)")


def read(rec: dict):
    t = rec["timers"]
    n = t.get("device-timed reads", 0)
    if not n:
        return None
    return sum(t.get(s, 0.0) for s in SPANS) / n * 1e6
