"""upload_mb.prove: per traced proof, the bytes the program copied to the
device (the ``h2d_bytes`` counts of the proof's spans), in MB of 1e6
bytes."""

from benchmark import program_spans


def read(rec):
    got = program_spans.mean(rec, "prove", "h2d_bytes")
    return None if got is None else got / 1e6
