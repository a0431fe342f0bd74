"""Stream time (the card's waits on the host included) of the repetitive
groups' approximate seed search: the seconds between the CUDA events that
bound the phase "repetitive seed search (device time)" of both strata, per
million reads of the batches whose device time was taken ("device-timed
reads"). None where no batch was timed."""


def read(rec: dict):
    t = rec["timers"]
    n = t.get("device-timed reads", 0)
    if not n:
        return None
    return t.get("repetitive seed search (device time)", 0.0) / n * 1e6
