"""One client in a closed loop.  ``provers`` provers are synthesized in
set-up for leaves drawn from the seed; each step restores the next in
turn from its snapshot with fresh seeded prover randomness, proves, and
verifies that proof alone through the port's verifier.  A cold and a warm
step run in set-up; ``traced_steps`` more run under the profiler after
the window when tracing.  After the window the port's verifier must also
refuse a proof with one byte flipped and a proof against another root;
``check`` proofs of the window, drawn from the seed, go to the reference.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import drive
from benchmark.trace import Trace


def run(rec, system, inputs, seconds, trace, device, fault, t_start):
    traffic = rec.traffic
    K = traffic["provers"]
    provers = []
    for k in range(K):
        c = inputs.case(k)
        prover, comms = system.prover(c.key, c.value, c.prover_seed,
                                      c.blind_seed)
        provers.append((prover, comms, prover.snapshot(), c))
    t_synth = time.perf_counter()
    rec.setup_parts["provers_s"] = t_synth - t_start - sum(
        rec.setup_parts.values())

    def step(i, record=True):
        prover, comms, snap, _ = provers[i % K]
        prover.restore(snap)
        prover.rng = np.random.RandomState(inputs.step_seed(i))
        n0 = drive.launch_count()
        with rec.spans.span("prove", i):
            proof = prover.prove(system.gens, backend=system.backend)
            drive.sync(device)
        launches = drive.launch_count() - n0
        if fault is not None:
            proof = fault("proof", i, proof)
        with rec.spans.span("verify", i):
            ok = system.verify(comms, proof)
            drive.sync(device)
        if record:
            rec.launches.append(launches)
        return proof, ok

    for i in (-2, -1):  # a cold prove (tables built), a warm one, verifies
        step(i, record=False)
    t0 = time.perf_counter()
    rec.setup_s = t0 - t_start
    rec.setup_parts["warm_s"] = t0 - t_synth
    proofs, rejected_by_port, i = [], 0, 0
    while time.perf_counter() < t0 + seconds:
        proof, ok = step(i)
        proofs.append((i, proof))
        rejected_by_port += not ok
        i += 1
    rec.window = (t0, time.perf_counter())
    rec.attempted, rec.failed = len(proofs), rejected_by_port
    if trace:
        rec.spans.tracing = True
        prof = drive.profiler(device)
        with prof:
            anchor = drive.anchor()
            a = time.perf_counter()
            for j in range(traffic["traced_steps"]):
                step(i + j, record=False)
            b = time.perf_counter()
        rec.spans.tracing = False

        rec.trace = Trace(prof, a, b, rec.spans.items, anchor)
    # the port's verifier must also refuse: a proof with one byte flipped,
    # and the last proof against a root that is not the tree's
    last_i, last = proofs[-1]
    _, comms, _, _ = provers[last_i % K]
    raw = bytearray(last.to_bytes())
    raw[len(raw) - 64] ^= 1
    bp = system.bp
    accepted = int(system.verify(comms, bp.R1CSProof.from_bytes(bytes(raw))))
    tape, system.tape = system.tape, system.comp.tape(
        bp.Scalar((system.tree.root.v + 1) % bp.L))
    accepted += int(system.verify(comms, last))
    system.tape = tape
    rec.checks["port_verdicts_wrong"] = (rejected_by_port + accepted, 0)
    rec.checks["proofs_repeated"] = (
        len(proofs) - len({p.to_bytes() for _, p in proofs}), 0)
    chosen = inputs.sample("check", [j for j, _ in proofs], traffic["check"])
    by = dict(proofs)
    return [(provers[j % K][3], provers[j % K][1], by[j].to_bytes())
            for j in chosen]
