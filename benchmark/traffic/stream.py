"""A closed-loop prover service: ``prove_stream`` with ``wave`` and
``inflight``, every proof a fresh witness built lazily by
``make_prover``.  Set-up ends once every worker has completed its first
group; at the window's end ``stop_event`` is set and the groups in flight
drain.  The first ``trace_seconds`` of the window run under the profiler
when tracing; ``check`` proofs completed in the window, drawn from the
seed, go to the reference.
"""

from __future__ import annotations

import os
import threading
import time

from benchmark import drive
from benchmark.trace import Trace


def run(rec, system, inputs, seconds, trace, device, fault, t_start):
    from bulletproofs_r1cs_gadgets_tpu_torch import prove_stream

    traffic = rec.traffic
    wave, inflight = traffic["wave"], traffic["inflight"]
    workers = max(1, inflight // wave)
    built, results, lock = {}, {}, threading.Lock()

    def make_prover(i):
        c = inputs.case(i)
        with rec.spans.span("make_prover", i):
            prover, comms = system.prover(c.key, c.value, c.prover_seed,
                                          c.blind_seed)
        with lock:
            built[i] = (c, comms)
        return prover

    def on_result(i, proof):
        if fault is not None:
            proof = fault("proof", i, proof)
        if proof is not None:
            with lock:
                results[i] = (time.perf_counter(), proof.to_bytes())

    def progress(done, _elapsed):
        with lock:
            rec.completions.append(
                (time.perf_counter(), threading.get_ident(), done))

    stop, errors = threading.Event(), []

    def serve():
        try:
            prove_stream(make_prover, 10**5, system.gens,
                         backend=system.backend, wave=wave, inflight=inflight,
                         keep=False, on_result=on_result, progress=progress,
                         stop_event=stop)
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    server = threading.Thread(target=serve, daemon=True)
    server.start()
    t_synth = time.perf_counter()
    while len({c[1] for c in rec.completions}) < workers:
        if errors or not server.is_alive():
            stop.set()
            raise RuntimeError(f"the stream stopped in set-up: {errors}")
        time.sleep(0.01)
    with lock:
        t0 = max(c[0] for c in rec.completions)
    rec.setup_s = t0 - t_start
    rec.setup_parts["warm_s"] = t0 - t_synth
    cpu0 = time.process_time()
    end = t0 + seconds
    prof = None
    if trace:
        rec.spans.tracing = True
        prof = drive.profiler(device)
        prof.__enter__()
        anchor = drive.anchor()
        a = time.perf_counter()
        time.sleep(max(0.0, min(end, a + traffic["trace_seconds"]) - a))
        b = time.perf_counter()
        prof.__exit__(None, None, None)
        rec.spans.tracing = False
    time.sleep(max(0.0, end - time.perf_counter()))
    rec.cpu = (time.process_time() - cpu0, len(os.sched_getaffinity(0)))
    stop.set()
    rec.window = (t0, end)
    server.join(timeout=600)
    if server.is_alive() or errors:
        raise RuntimeError(f"the stream did not drain: {errors}")
    if prof is not None:

        rec.trace = Trace(prof, a, b, rec.spans.items, anchor)
    in_window = [i for i, (t, _) in results.items() if t0 < t <= end]
    rec.attempted = len(in_window)
    missing = len(set(built) - set(results))
    rec.failed = missing
    rec.checks["proofs_missing"] = (missing, 0)
    rec.checks["proofs_repeated"] = (
        len(results) - len({p for _, p in results.values()}), 0)
    chosen = inputs.sample("check", sorted(in_window), traffic["check"])
    return [(built[i][0], built[i][1], results[i][1]) for i in chosen]
