"""Structured metrics & observability.

SURVEY.md §5 (tracing/profiling, metrics/logging): the reference only has
ad-hoc ``std::time::Instant`` + ``println!`` sites (e.g.
``reference/src/gadget_poseidon.rs:734-749``,
``gadget_vsmt_2.rs:332-350``).  Here the equivalent signals are
first-class and machine-readable:

* :class:`Metrics` — a process-wide registry of named wall-time
  accumulators and counters.  The prover/verifier/backends feed it their
  phase timings; ``snapshot()`` returns a plain dict and ``write_json()``
  persists it, so a serving deployment can scrape proof-phase breakdowns
  instead of parsing stderr.
* :func:`annotate` — names a host-side region so it shows up as a span in
  a ``torch.profiler`` trace (``torch.profiler.record_function``).
* :func:`device_trace` — wraps ``torch.profiler.profile`` to capture a
  per-kernel device trace for a region (a Chrome trace file).

Env knobs:
  ``BPTPU_TIMING=1``        — also print human-readable phase lines to
                              stderr (round-1 behaviour, kept).
  ``BPTPU_METRICS=path.json`` — at interpreter exit, write the final
                              snapshot to ``path.json``.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from contextlib import contextmanager

TIMING = os.environ.get("BPTPU_TIMING", "") not in ("", "0")
_METRICS_PATH = os.environ.get("BPTPU_METRICS", "")


class Metrics:
    """Thread-safe named wall-time accumulators + counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.timers: dict[str, float] = {}
        self.timer_calls: dict[str, int] = {}
        self.counters: dict[str, int] = {}

    # ------------------------------------------------------------- record
    def add_time(self, name: str, dt: float) -> None:
        with self._lock:
            self.timers[name] = self.timers.get(name, 0.0) + dt
            self.timer_calls[name] = self.timer_calls.get(name, 0) + 1

    def add_count(self, name: str, v: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + v

    @contextmanager
    def phase(self, name: str):
        """``with METRICS.phase("prove.ipp"): ...`` times the block."""
        t0 = time.time()
        try:
            yield
        finally:
            self.add_time(name, time.time() - t0)

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "timers_s": {k: round(v, 6) for k, v in self.timers.items()},
                "timer_calls": dict(self.timer_calls),
                "counters": dict(self.counters),
            }

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self.timers.clear()
            self.timer_calls.clear()
            self.counters.clear()

    # ------------------------------------------------- human-readable dump
    def dump_group(self, prefix: str, label: str | None = None) -> None:
        """Print one ``[timing:label] total=.. a=.. b=..`` stderr line for
        the timers under ``prefix.`` and clear them (round-1 `_Timer.dump`
        semantics, now sourced from the shared registry).  No-op when
        BPTPU_TIMING is off, so the accumulators stay available for a
        ``BPTPU_METRICS`` snapshot."""
        if not TIMING:
            return
        with self._lock:
            keys = [k for k in self.timers if k.startswith(prefix + ".")]
            acc = {k[len(prefix) + 1:]: self.timers.pop(k) for k in keys}
            for k in keys:
                self.timer_calls.pop(k, None)
        if acc:
            total = sum(acc.values())
            parts = ", ".join(
                f"{k}={v:.2f}s" for k, v in sorted(acc.items())
            )
            print(
                f"[timing:{label or prefix}] total={total:.2f}s {parts}",
                file=sys.stderr, flush=True,
            )


METRICS = Metrics()

if _METRICS_PATH:
    atexit.register(lambda: METRICS.write_json(_METRICS_PATH))


@contextmanager
def annotate(name: str):
    """Named span visible in a ``torch.profiler`` trace (no-op cost when
    no trace is active)."""
    import torch.profiler

    with torch.profiler.record_function(name):
        yield


@contextmanager
def device_trace(logdir: str):
    """Capture a per-kernel device trace (Chrome trace JSON under
    `logdir`) for the enclosed region:
    ``with device_trace("/tmp/trace"): prove(...)``."""
    import torch
    import torch.profiler

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
