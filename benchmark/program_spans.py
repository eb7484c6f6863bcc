"""The program's own spans, as the per-layer readers see them.

The port records spans and counters inside its prover, verifier and
backend seam (``bulletproofs_r1cs_gadgets_tpu_torch/utils/metrics.py``)
while a profiler runs, so in the traced steps after the window, on the
host's perf_counter clock (the clock of ``rec.window``).  A proof's spans
share its top span's proof id.  A program that records no spans gives
none here, and the readers then find nothing to read.
"""

from __future__ import annotations

# the backend seam's calls: the top spans' children that the engine hands
# to the backend
SEAM = ("phase_commitments", "ipp_create", "msm_gens")


def recorded() -> list:
    try:
        from bulletproofs_r1cs_gadgets_tpu_torch.utils import metrics
    except ImportError:
        return []
    read = getattr(metrics, "spans", None)
    return list(read()) if callable(read) else []


def traced(rec, name: str) -> list[tuple]:
    """(top span, the spans of its proof) for each of the program's
    top-level `name` spans (``prove``, ``verify``) that start after the
    window: the traced steps."""
    spans = recorded()
    by: dict = {}
    for s in spans:
        by.setdefault(s.proof, []).append(s)
    return [(s, by[s.proof]) for s in spans
            if s.name == name and s.parent is None and s.start >= rec.window[1]]


def split(top, spans) -> dict:
    """A top span's wall time in ms, in three parts that add up to it:
    ``self`` (the top minus its seam children), ``seam_host`` (the seam
    children minus the proof's ``seam.fetch`` spans) and ``device_wait``
    (the ``seam.fetch`` spans: the host blocked on a sync); and the
    proof's ``h2d_bytes``."""
    seam = sum(s.end - s.start for s in spans
               if s.parent == top.id and s.name in SEAM)
    wait = sum(s.end - s.start for s in spans if s.name == "seam.fetch")
    return {"self": 1e3 * (top.end - top.start - seam),
            "seam_host": 1e3 * (seam - wait),
            "device_wait": 1e3 * wait,
            "h2d_bytes": sum(s.counts.get("h2d_bytes", 0) for s in spans)}


def mean(rec, name: str, part: str):
    """The mean of one part of :func:`split` over the traced `name`
    spans, or None where the program recorded none."""
    got = [split(top, spans)[part] for top, spans in traced(rec, name)]
    return sum(got) / len(got) if got else None
