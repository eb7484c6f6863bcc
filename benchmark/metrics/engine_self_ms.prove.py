"""engine_self_ms.prove: per traced proof, the program's ``prove`` span
minus its two seam children (``phase_commitments``, ``ipp_create``): the
engine's own host work (``benchmark/program_spans.py``)."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean(rec, "prove", "self")
