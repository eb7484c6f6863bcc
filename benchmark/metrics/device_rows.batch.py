"""device_rows.batch: per traced batch verification, the G/H coefficient
rows the program built on the device for the batch's combined MSM: the
``device_rows`` count of the ``msm_gens`` span directly under each traced
``batch_verify`` (a refused batch's one-proof re-checks, under
``batch_verify.recheck``, are not read), averaged over the traced batches:
2 x the padded size where the device builds and sums the batch's rows, 0
where the host does.  None where the program counts no ``device_rows``
there."""

from benchmark import program_spans


def read(rec):
    got = [[s.counts["device_rows"] for s in spans
            if s.parent == top.id and s.name == "msm_gens"
            and "device_rows" in s.counts]
           for top, spans in program_spans.traced(rec, "batch_verify")]
    if not got or not all(got):
        return None
    return sum(sum(g) for g in got) / len(got)
