"""seam_host_ms.prove: per traced proof, the program's seam spans
(``phase_commitments``, ``ipp_create``) minus the time in their
``seam.fetch`` spans: the backend's host work, encoding and launches."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean(rec, "prove", "seam_host")
