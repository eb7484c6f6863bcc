"""engine_host_ms.prove: per traced proof, prove wall time minus the
device-busy time inside it: the engine's host work and its waits."""


def read(rec):
    got = rec.trace.per_span("prove") if rec.trace is not None else []
    if not got:
        return None
    return 1e3 * sum(w - b for w, b in got) / len(got)
