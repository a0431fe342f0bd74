"""Stream time (the card's waits on the host included) of the bin mappers'
exact map steps: the seconds between the CUDA events of the span "map step
(device time)" around each chunk's upload, seed search, locate, dedup and
verify, per million reads of the batches whose device time was taken
("device-timed reads"). None where no batch was timed."""


def read(rec: dict):
    t = rec["timers"]
    n = t.get("device-timed reads", 0)
    if not n:
        return None
    return t.get("map step (device time)", 0.0) / n * 1e6
