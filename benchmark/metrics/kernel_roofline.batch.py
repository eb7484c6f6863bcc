"""kernel_roofline.batch: the least device time of a batch's group
operations, the configuration's ``batch`` times one proof's
(``benchmark/counts.py``: the proofs' MSMs and folds are independent, so
the sum is still a floor), over the device-busy time of the traced
batches' ``prove`` spans, in percent."""

from benchmark import counts


def read(rec):
    got = rec.trace.per_span("prove") if rec.trace is not None else []
    busy = sum(b for _, b in got) / len(got) if got else 0.0
    peaks = counts.PEAKS.get(rec.device_name)
    if busy <= 0 or peaks is None:
        return None
    floor = counts.prove_floor_s(rec.shapes["n"], rec.shapes["padded"], peaks)
    return 100.0 * rec.config["batch"] * floor / busy
