"""device_wait_ms.prove: per traced proof, the time in the program's
``seam.fetch`` spans: the host blocked on a device sync and the copy
back.  With engine_self_ms.prove and seam_host_ms.prove it adds up to the
program's prove span."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean(rec, "prove", "device_wait")
