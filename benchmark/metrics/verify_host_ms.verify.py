"""verify_host_ms.verify: per traced verification, the program's
``verify`` span minus its seam child ``msm_gens``: the verifier's scalar
work on the host."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean(rec, "verify", "self")
