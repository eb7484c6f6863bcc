"""device_idle.prove: 1 - device-busy time / wall time over the traced
proves, in percent (the union of the trace's device intervals)."""


def read(rec):
    got = rec.trace.per_span("prove") if rec.trace is not None else []
    wall = sum(w for w, _ in got)
    if wall <= 0 or not any(b for _, b in got):
        return None
    return 100.0 * (1.0 - sum(b for _, b in got) / wall)
