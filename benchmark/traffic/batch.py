"""A batched prover service, one client batch at a time in a closed loop.
The configuration's ``batch`` provers are synthesized in set-up for
leaves drawn from the seed; each step restores all of them from their
snapshots with fresh seeded prover randomness, proves them together
through ``prove_provers`` and checks the batch with one
``batch_verify``.  So ``prove`` and ``verify`` spans are a batch's.  A
cold and a warm batch run in set-up; ``traced_steps`` more run under the
profiler after the window when tracing.  After the window the port's
batch verifier must also refuse the last batch with one proof's byte
flipped, naming exactly that index, and the last batch against another
root, naming every index; ``check`` proofs of the window, drawn from the
seed, go to the reference.
"""

from __future__ import annotations

import re
import sys
import time

import numpy as np

from benchmark import drive
from benchmark.trace import Trace

NAMED = re.compile(r"invalid proof indices: \[([0-9, ]*)\]")


def named(err) -> list[int] | None:
    """The indices a refused batch's error names (None if it names none)."""
    got = NAMED.search(str(err))
    if got is None:
        return None
    return [int(x) for x in got.group(1).split(",") if x.strip()]


def launches_by_kernel() -> dict:
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve

    return dict(cuda_curve.LAUNCHES)


def run(rec, system, inputs, seconds, trace, device, fault, t_start):
    bp = system.bp
    traffic, config = rec.traffic, rec.config
    B = config["batch"]
    workers = config.get("prove_host_workers")
    provers = []
    for b in range(B):
        c = inputs.case(b)
        prover, comms = system.prover(c.key, c.value, c.prover_seed,
                                      c.blind_seed)
        provers.append((prover, comms, prover.snapshot(), c))
    t_synth = time.perf_counter()
    rec.setup_parts["provers_s"] = t_synth - t_start - sum(
        rec.setup_parts.values())

    def verifier(comms):
        """A verifier built as ``System.verify`` builds one."""
        v = bp.Verifier(bp.Transcript(system.label))
        system.comp.commit_verifier(v, comms, system.pc)
        v.load_compiled(system.tape, system.comp.num_multipliers)
        return v

    def batch_verify(batch):
        """The port's verdict on [(b, proof)]: None if it accepts, else
        the refusal."""
        try:
            bp.batch_verify([verifier(provers[b][1]) for b, _ in batch],
                            [p for _, p in batch], system.pc, system.gens,
                            backend=system.backend)
        except bp.VerificationError as err:
            return err
        return None

    def step(i, record=True):
        for b, (prover, _, snap, _) in enumerate(provers):
            prover.restore(snap)
            prover.rng = np.random.RandomState(inputs.step_seed(B * i + b))
        kw = {} if workers is None else {"host_workers": workers}
        n0 = drive.launch_count()
        with rec.spans.span("prove", i):
            proofs = bp.prove_provers([p for p, _, _, _ in provers],
                                      system.gens, backend=system.backend,
                                      **kw)
            drive.sync(device)
        launches = drive.launch_count() - n0
        if fault is not None:
            proofs = [fault("proof", B * i + b, p) for b, p in enumerate(proofs)]
        batch = [(b, p) for b, p in enumerate(proofs) if p is not None]
        with rec.spans.span("verify", i):
            err = batch_verify(batch)
            drive.sync(device)
        if record:
            rec.launches.append(launches)
        return batch, err

    for i in (-2, -1):  # a cold batch (tables built), a warm one
        batch, _ = step(i, record=False)
    t0 = time.perf_counter()
    rec.setup_s = t0 - t_start
    rec.setup_parts["warm_s"] = t0 - t_synth
    proofs, refused, missing, i = [], 0, 0, 0
    while time.perf_counter() < t0 + seconds:
        if i == 0:
            before = launches_by_kernel()
        batch, err = step(i)
        if i == 0:
            after = launches_by_kernel()
            print("launches by kernel, one batch of %d: %s" % (B, {
                k: after[k] - before.get(k, 0) for k in sorted(after)
                if after[k] - before.get(k, 0)}), file=sys.stderr)
        proofs += [(B * i + b, p) for b, p in batch]
        missing += B - len(batch)
        refused += err is not None
        i += 1
    rec.window = (t0, time.perf_counter())
    rec.attempted = B * i
    rec.failed = B * refused + missing
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
    # the port's batch verifier must also refuse, and name the proofs at
    # fault: the last batch with one proof's byte flipped, and the last
    # batch against a root that is not the tree's
    last = batch
    k = inputs.sample("flip", list(range(len(last))), 1)[0]
    raw = bytearray(last[k][1].to_bytes())
    raw[len(raw) - 64] ^= 1
    flipped = list(last)
    flipped[k] = (last[k][0], bp.R1CSProof.from_bytes(bytes(raw)))
    err = batch_verify(flipped)
    wrong = int(err is None or named(err) != [k])
    tape, system.tape = system.tape, system.comp.tape(
        bp.Scalar((system.tree.root.v + 1) % bp.L))
    err = batch_verify(last)
    system.tape = tape
    wrong += int(err is None or named(err) != list(range(len(last))))
    rec.checks["port_verdicts_wrong"] = (refused + wrong, 0)
    rec.checks["proofs_repeated"] = (
        len(proofs) - len({p.to_bytes() for _, p in proofs}), 0)
    rec.checks["proofs_missing"] = (missing, 0)
    chosen = inputs.sample("check", [j for j, _ in proofs], traffic["check"])
    by = dict(proofs)
    return [(provers[j % B][3], provers[j % B][1], by[j].to_bytes())
            for j in chosen]
