"""Reading a ``torch.profiler`` trace of the card: the union of the
device's busy intervals (copied from the port's ``chip_profile.py``
arithmetic), the device time per operation, and the idle gaps named by
the benchmark span the host was in.

Times are in the trace's microseconds.  The benchmark's spans appear in
the trace as ``bench.<name>`` ranges (``spans.Spans`` while tracing);
their device-side mirrors are left out of the busy time.
"""

from __future__ import annotations


def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged, lo: float, hi: float) -> float:
    """Length of [lo, hi) that the merged intervals cover."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


class Trace:
    def __init__(self, prof, t_start: float, t_end: float, host_spans=(),
                 anchor: float | None = None):
        """`prof` a finished profiler; [t_start, t_end) the host
        perf_counter seconds it ran over (the window's length).
        `host_spans` (``Spans.items``) name the idle gaps on every thread
        when `anchor`, the host time of the ``bench.anchor`` range, ties the
        two clocks together."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        dev, ops, spans = [], {}, {}
        for e in prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.name.startswith("bench."):
                if e.device_type != cuda:
                    spans.setdefault(e.name[6:], []).append((a, b))
                continue
            if e.device_type == cuda:
                dev.append((a, b))
                name = e.name if len(e.name) <= 80 else e.name[:77] + "..."
                ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
        anchors = spans.pop("anchor", [])
        self.offset = (anchor - anchors[0][0] * 1e-6
                       if anchor is not None and anchors else None)
        self.host_spans = list(host_spans)
        self.busy = union(dev)
        self.ops = ops
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self.window_s = t_end - t_start
        starts = [a for a, _ in dev] + [a for v in spans.values() for a, _ in v]
        ends = [b for _, b in dev] + [b for v in spans.values() for _, b in v]
        self.lo = min(starts) if starts else 0.0
        self.hi = max(ends) if ends else 0.0

    def busy_s(self, lo: float | None = None, hi: float | None = None) -> float:
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        return covered(self.busy, lo, hi) * 1e-6

    def per_span(self, name: str) -> list[tuple[float, float]]:
        """(wall seconds, device-busy seconds inside it) of each traced
        benchmark span `name`."""
        return [((b - a) * 1e-6, self.busy_s(a, b))
                for a, b in self.spans.get(name, [])]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps, each named by the innermost benchmark span around it."""
        dops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.lo
        for a, b in self.busy + [(self.hi, self.hi)]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        named = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            named.append([self._doing((a + b) / 2), (b - a) * 1e-6])
        return {"device_ops": [[k, v] for k, v in dops],
                "idle_gaps": named}

    def _doing(self, mid: float) -> str:
        """What the host was in at trace time `mid`: the benchmark spans
        open on any thread (by the host clock), else the innermost traced
        one of this thread."""
        if self.offset is not None:
            t = self.offset + mid * 1e-6
            names = sorted({n for n, a, b, _, _ in self.host_spans if a <= t < b})
            if names:
                return "+".join(names)
        name, start = "outside the spans", None
        for k, ivs in self.spans.items():
            for s, e in ivs:
                if s <= mid < e and (start is None or s > start):
                    name, start = k, s
        return name
