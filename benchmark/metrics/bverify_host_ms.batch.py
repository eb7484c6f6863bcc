"""bverify_host_ms.batch: per traced batch verification, the program's
``batch_verify`` span minus its seam child ``msm_gens``: the batch
verifier's host work, its jobs (transcript replays, host G/H rows) and the
random linear combination.  None where the program records no
``batch_verify``."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean(rec, "batch_verify", "self")
