"""msm_gens_ms.verify: mean wall time of the backend seam's msm_gens (the
verifier's one multiscalar multiplication) in the window's verifies."""


def read(rec):
    spans = rec.spans.of("msm_gens", *rec.window)
    if not spans:
        return None
    return 1e3 * sum(b - a for _, a, b, _, _ in spans) / len(spans)
