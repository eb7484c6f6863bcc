"""Streamed batched proving at arbitrary batch size.

The BASELINE target workload is 4096 concurrent VSMT-2 proofs
(BASELINE.md, workload defined by the reference's
``gadget_vsmt_2.rs:290`` test configuration).  ``prove_provers``
(:mod:`.batch`) holds every prover in memory at once — at 4096 proofs
that is ~60 GB of host witness state and far past the chip's ~12-job
in-flight HBM ceiling (PERF_NOTES "HBM accounting").  ``prove_stream``
instead treats the batch as a QUEUE:

* provers are built LAZILY in wave-sized groups (``make_prover(i)``,
  e.g. stamping a compiled circuit template with fresh witnesses), so
  host memory is O(workers * wave), not O(count);
* ``workers = inflight // wave`` group pipelines run on threads, each
  proving its group with the staged-fusion path (one group's host build
  and transcript stages overlap the other groups' device waits — the
  same interleaving as ``prove_provers(waves=...)``, extended to an
  unbounded stream);
* finished proofs are handed to ``on_result`` (or collected) and their
  prover state is dropped before the next group starts, so at most
  ``inflight`` proofs own device arrays at any instant.

This is the JAX package's ``parallel/stream.py`` with one change: its
device-memory probe (``jax.local_devices()[0].memory_stats()``) is
``torch.cuda.max_memory_allocated`` of the backend's card.

Proof bytes are identical to the sequential path for provers with
deterministic private rngs (grouping only interleaves independent
pipelines — the ``prove_provers`` guarantee).
"""

from __future__ import annotations

import os
import time
import threading
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..core.proof import R1CSProof
from ..core.pedersen import BulletproofGens
from ..ops.torch_backend import TorchBackend
from .batch import prove_provers


@dataclass
class StreamReport:
    """Telemetry of one :func:`prove_stream` run."""

    count: int
    wave: int
    inflight: int
    wall_s: float
    proofs_per_s: float
    build_s: float  # aggregate host prover-build time (overlapped)
    prove_s: float  # aggregate in-group prove wall time (overlapped)
    cpu_util: float  # process CPU seconds / (wall * cores)
    hbm_peak_bytes: int | None  # device allocator peak, if exposed
    group_times: list[float] = field(default_factory=list)


def _hbm_peak(backend) -> int | None:
    """Device allocator peak of a backend on a card
    (``torch.cuda.max_memory_allocated``); None on the host."""
    dev = getattr(backend, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return None  # a backend on the CPU
    return int(torch.cuda.max_memory_allocated(dev))


def prove_stream(
    make_prover: Callable[[int], object],
    count: int,
    bp_gens: BulletproofGens,
    backend=None,
    wave: int = 4,
    inflight: int = 12,
    on_result: Callable[[int, R1CSProof], None] | None = None,
    keep: bool = True,
    progress: Callable[[int, float], None] | None = None,
    stop_event: threading.Event | None = None,
) -> tuple[list[R1CSProof] | None, StreamReport]:
    """Prove ``count`` lazily-built provers with at most ``inflight``
    proofs' device state live.

    ``make_prover(i)`` must return a fully synthesized Prover for stream
    index ``i`` (thread-safe: called from worker threads).  With
    ``keep=False`` proofs are NOT accumulated (pass ``on_result`` to
    consume them) — constant host memory for arbitrarily large streams.
    ``progress(done, elapsed_s)`` fires after every retired group.
    ``stop_event`` drains the queue gracefully: no NEW group starts once
    set, in-flight groups finish and are reported (clean early
    termination for deadline-bounded runs — the report's ``count``
    reflects the proofs actually produced).  ``backend=None`` proves on
    the card (``TorchBackend()``, which raises without one); CPU runs
    pass a backend on ``"cpu"``."""
    if backend is None:
        backend = TorchBackend()
    if count <= 0:
        return ([] if keep else None), StreamReport(
            0, wave, inflight, 0.0, 0.0, 0.0, 0.0, 0.0, None
        )
    wave = max(1, min(wave, count))
    workers = max(1, inflight // wave)
    groups = [(s, min(s + wave, count)) for s in range(0, count, wave)]
    out: list[R1CSProof] | None = [None] * count if keep else None
    lock = threading.Lock()
    state = {"next": 0, "done": 0, "build": 0.0, "prove": 0.0}
    errors: list[BaseException] = []
    t_start = time.time()
    cpu0 = time.process_time()
    group_times: list[float] = []

    def worker():
        while True:
            if stop_event is not None and stop_event.is_set():
                return
            with lock:
                if errors or state["next"] >= len(groups):
                    return
                g = groups[state["next"]]
                state["next"] += 1
            try:
                t0 = time.time()
                provers = [make_prover(i) for i in range(g[0], g[1])]
                t1 = time.time()
                proofs = prove_provers(provers, bp_gens, backend=backend)
                t2 = time.time()
                del provers
                # Large witness/word numpy buffers routinely sit in
                # reference cycles (prover <-> tape <-> closures); the
                # cyclic GC triggers on OBJECT counts, which a stream of
                # few-object/huge-buffer proofs barely advances — the
                # 4096-proof run leaked ~150 MB/proof host RSS until the
                # kernel OOM-killed it at 130 GB.  One collect per
                # retired group (~tens of ms) keeps RSS flat.
                import gc

                gc.collect()
                with lock:
                    state["build"] += t1 - t0
                    state["prove"] += t2 - t1
                    state["done"] += g[1] - g[0]
                    done = state["done"]
                    group_times.append(t2 - t0)
                for i, pf in zip(range(g[0], g[1]), proofs):
                    if out is not None:
                        out[i] = pf
                    if on_result is not None:
                        on_result(i, pf)
                if progress is not None:
                    progress(done, time.time() - t_start)
            except BaseException as e:  # propagate to caller
                with lock:
                    errors.append(e)
                return

    threads = [
        threading.Thread(target=worker, daemon=True) for _ in range(workers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    wall = time.time() - t_start
    cpu = time.process_time() - cpu0
    report = StreamReport(
        count=state["done"],
        wave=wave,
        inflight=workers * wave,
        wall_s=wall,
        proofs_per_s=state["done"] / wall if wall > 0 else 0.0,
        build_s=state["build"],
        prove_s=state["prove"],
        cpu_util=cpu / (wall * (os.cpu_count() or 1)) if wall > 0 else 0.0,
        hbm_peak_bytes=_hbm_peak(backend),
        group_times=group_times,
    )
    return out, report
