"""device_rows.verify: per traced verification, the verifier's G/H
coefficient rows the program built on the device (the ``device_rows``
counts of the verification's spans, which the backend's ``msm_gens`` span
carries): 2 x the padded size where the rows are built on the device, 0
where the host builds them.  None where the program counts no
``device_rows``."""

from benchmark import program_spans


def read(rec):
    got = [[s.counts["device_rows"] for s in spans
            if "device_rows" in s.counts]
           for _, spans in program_spans.traced(rec, "verify")]
    if not got or not all(got):
        return None
    return sum(sum(g) for g in got) / len(got)
