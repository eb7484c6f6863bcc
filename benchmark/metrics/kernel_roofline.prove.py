"""kernel_roofline.prove: the least device time of one proof's group
operations at its shapes (``benchmark/counts.py``: the phase-1 MSMs, each
IPP round's MSMs and folds, against the card's peaks) over the device-busy
time of the traced proves, in percent."""

from benchmark import counts


def read(rec):
    got = rec.trace.per_span("prove") if rec.trace is not None else []
    busy = sum(b for _, b in got) / len(got) if got else 0.0
    peaks = counts.PEAKS.get(rec.device_name)
    if busy <= 0 or peaks is None:
        return None
    floor = counts.prove_floor_s(rec.shapes["n"], rec.shapes["padded"], peaks)
    return 100.0 * floor / busy
