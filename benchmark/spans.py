"""The benchmark's own spans around its calls into the program.

A span is (name, start, end, key, thread) on the host's perf_counter
clock.  While a profiler runs, each span is also a ``record_function``
range named ``bench.<name>``, so the trace can be cut by it.
"""

from __future__ import annotations

import contextlib
import threading
import time


class Spans:
    def __init__(self):
        self.items: list[tuple] = []
        self.tracing = False
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, key=None):
        ctx = contextlib.nullcontext()
        if self.tracing:
            import torch

            ctx = torch.profiler.record_function(f"bench.{name}")
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.items.append((name, t0, t1, key, threading.get_ident()))

    def of(self, name: str, lo: float = float("-inf"), hi: float = float("inf")):
        """Spans of `name` that start in [lo, hi)."""
        return [s for s in self.items if s[0] == name and lo <= s[1] < hi]
