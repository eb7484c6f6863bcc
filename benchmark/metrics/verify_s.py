"""verify_s: the window's total verify wall time over its verifications
(host clock, each ending in a device synchronise)."""


def read(rec):
    spans = rec.spans.of("verify", *rec.window)
    if not spans:
        return None
    return sum(b - a for _, a, b, _, _ in spans) / len(spans)
