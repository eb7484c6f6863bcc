"""prove_s: the window's total prove wall time over the proofs it made
(host clock, each prove ending in a device synchronise)."""


def read(rec):
    spans = rec.spans.of("prove", *rec.window)
    if not spans:
        return None
    return sum(b - a for _, a, b, _, _ in spans) / len(spans)
