"""Whether what the window produced is correct: the checked proofs go to
the plain reference (``reference/``), which works the statement out again
from the inputs and judges each proof against it.  Every number compared
is a count with the limit 0.  The reference's part times go into
`times`."""

from __future__ import annotations


def judge(config: dict, inputs, judged: list, expected: int, device,
          times: dict) -> dict:
    from .reference.verify import Reference

    ref = Reference(config, device)
    cases = [dict(key=c.key, value=c.value, blind_seed=c.blind_seed,
                  comms=[bytes(x) for x in comms], proof=bytes(raw))
             for c, comms, raw in judged]
    got = ref.judge(inputs.items, cases, seed=inputs.seed)
    times.update(got["times"])
    return {
        "proofs_unchecked": (max(0, expected - len(cases)), 0),
        "proofs_rejected": (got["proofs_rejected"], 0),
        "commitments_differ": (got["commitments_differ"], 0),
    }
