"""ipp_ms.prove: mean wall time of the backend seam's ipp_create in the
window's proofs (the benchmark's wrapper; it returns host points, so the
device work is done)."""


def read(rec):
    spans = rec.spans.of("ipp_create", *rec.window)
    if not spans:
        return None
    return 1e3 * sum(b - a for _, a, b, _, _ in spans) / len(spans)
