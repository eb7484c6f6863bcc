"""synth_ms.stream: mean wall time of the benchmark's span around
make_prover (witness, commitments and the compiled tape loaded into a
prover) for the provers the stream built in the window."""


def read(rec):
    spans = rec.spans.of("make_prover", *rec.window)
    if not spans:
        return None
    return 1e3 * sum(b - a for _, a, b, _, _ in spans) / len(spans)
