"""batch_self_ms.batch: per traced batch, the program's ``prove_batch``
span minus its seam children (``phase_commitments``, ``ipp_create``): the
batch's host work outside the seam, its phase-1 states and every
prover's stages 2-5 on the scheduler's pool (``benchmark/program_spans.py``).
None where the program records no ``prove_batch``."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean(rec, "prove_batch", "self")
