"""batch_wait_ms.batch: per traced batch, the time in the program's
``seam.fetch`` spans of the ``prove_batch`` tree (one a sync of the
batch): the host blocked on the device and the copy back.  None where the
program records no ``prove_batch``."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean(rec, "prove_batch", "device_wait")
