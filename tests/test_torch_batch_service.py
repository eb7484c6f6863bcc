"""The batched prover service of the benchmark's cell
``vsmt2-d253-b8.batch``: B = 3 restored VSMT-2 provers through
``prove_provers`` and one ``batch_verify``, held to the plain reference
(``benchmark/reference/``), on the CPU at small depths.

* The staged path (``prove_provers`` with the batch seam's methods) at
  depth 2: the proofs equal, byte for byte, each prover restored with the
  same randomness and proved alone; the reference accepts each with equal
  commitments; ``batch_verify`` accepts the honest batch, refuses one
  with a byte flipped naming exactly that index (the reference refuses
  that proof alone) and refuses the batch against another root naming
  every index (the reference refuses each): the batch's verdict is the
  conjunction of the reference's.  The seam's math here is the port's C++
  host library behind the two batch methods (``Staged``): the kernels'
  plain versions take over ten minutes a batch at this size on the CPU.
  The card's test runs the same checks through ``TorchBackend("cuda")``
  at depth 4, the flotilla (``msm_lane``) included.
* The spans of a batch on ``TorchBackend``'s batched seam (its plain
  kernels, an 8-multiplier circuit, every IPP round a flotilla round):
  one ``prove_batch`` tree whose three
  parts (``benchmark/program_spans.split``) add up to it, one
  ``batch_verify`` with its ``msm_gens``, a refused batch's
  ``batch_verify.recheck``; with the recorder off nothing is recorded and
  the bytes are the same.
* ``batch_verify`` with the G/H rows built on the device (a CPU
  ``TorchBackend`` whose walker range starts at 1, so its plain kernels
  build and sum them), on two-phase proofs padded to 64: the honest
  batch is accepted with 2N ``device_rows`` on its ``msm_gens``, a
  flipped byte is refused naming exactly its index, a false statement
  names every index; a batch of two padded sizes is summed on the device
  too; a batch whose smaller proof keeps the host's rows (the walker
  starting above its size) and one on a route with ``w5`` off are still
  judged right, the host's part with ``device_rows`` 0.
* The five readers of the cell on synthetic records, and None where the
  program recorded nothing for them.
* The batch traffic through ``benchmark.drive`` at depth 4 on
  ``NativeBackend`` (``prove_provers``' sequential path): a sound run is
  correct; ``tamper``, ``Stale`` and ``drop_half`` each read not correct.

Tolerance: exact (bytes, verdicts, indices, counts); the readers' values
to 1e-9 relative; the split's parts to 1% of the batch's wall time.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import bulletproofs_r1cs_gadgets_tpu_torch as port
from benchmark import counts, drive, faults, named, program_spans
from benchmark import run as bench
from benchmark.inputs import Inputs
from benchmark.reference.verify import Reference
from benchmark.spans import Spans
from benchmark.system import System
from bulletproofs_r1cs_gadgets_tpu_torch import (
    Route,
    TorchBackend,
    batch_verify,
    prove_provers,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import (
    NativeBackend)
from bulletproofs_r1cs_gadgets_tpu_torch.utils import metrics
from bulletproofs_r1cs_gadgets_tpu_torch.utils.metrics import Span
import test_torch_trace as small
import test_torch_verify_rows as tvr

torch.set_num_threads(1)

SEED = 2**31 + 977
B = 3
CELL = "vsmt2-d253-b8.batch"
with open(os.path.join(bench.ROOT, "benchmark", "configs",
                       "vsmt2-d253-b8.json")) as f:
    CONFIG = json.load(f)
with open(os.path.join(bench.ROOT, "benchmark", "traffic", "batch.json")) as f:
    TRAFFIC = json.load(f)
READERS = ("batch_self_ms.batch", "batch_wait_ms.batch",
           "bverify_host_ms.batch", "kernel_roofline.batch",
           "device_rows.batch")
named_indices = named.load("traffic", "batch").named


def _config(depth: int) -> dict:
    return dict(CONFIG, depth=depth, tree_updates=4, batch=B,
                generators=1 << (depth * 568 - 1).bit_length())


class Staged(NativeBackend):
    """The port's C++ host math behind the batch seam's two methods, so
    ``prove_provers`` takes its staged path."""

    def phase_commitments_batch(self, jobs):
        return [self.phase_commitments(*job) for job in jobs]

    def ipp_create_batch(self, jobs):
        return [self.ipp_create(*job) for job in jobs]


class Service:
    """B provers of one VSMT-2 tree, built as the benchmark builds them,
    and the plain reference of their configuration."""

    def __init__(self, backend, depth: int, device="cpu"):
        self.config = _config(depth)
        self.inputs = Inputs(self.config, SEED)
        self.system = System(self.config, self.inputs.items, device, Spans(),
                             backend)
        self.cases = [self.inputs.case(b) for b in range(B)]
        built = [self.system.prover(c.key, c.value, c.prover_seed,
                                    c.blind_seed) for c in self.cases]
        self.provers = [p for p, _ in built]
        self.comms = [c for _, c in built]
        self.snaps = [p.snapshot() for p in self.provers]
        self.reference = Reference(self.config, device)

    def restored(self) -> list:
        for b, (prover, snap) in enumerate(zip(self.provers, self.snaps)):
            prover.restore(snap)
            prover.rng = np.random.RandomState(self.inputs.step_seed(b))
        return self.provers

    def prove(self) -> list:
        return prove_provers(self.restored(), self.system.gens,
                             backend=self.system.backend)

    def alone(self) -> list:
        return [p.prove(self.system.gens, backend=NativeBackend())
                for p in self.restored()]

    def verdict(self, proofs, root_shift: int = 0):
        """None where ``batch_verify`` accepts, else the indices its
        refusal names; against the tree's root plus `root_shift`."""
        system, bp = self.system, port
        tape = system.tape
        if root_shift:
            tape = system.comp.tape(
                bp.Scalar((system.tree.root.v + root_shift) % bp.L))
        verifiers = []
        for comms in self.comms:
            v = bp.Verifier(bp.Transcript(system.label))
            system.comp.commit_verifier(v, comms, system.pc)
            v.load_compiled(tape, system.comp.num_multipliers)
            verifiers.append(v)
        try:
            batch_verify(verifiers, proofs, system.pc, system.gens,
                         backend=system.backend)
        except bp.VerificationError as err:
            return named_indices(err)
        return None

    def judged(self, proofs, which, items=None) -> dict:
        """The reference's judgement of the proofs at `which`."""
        cases = [dict(key=self.cases[b].key, value=self.cases[b].value,
                      blind_seed=self.cases[b].blind_seed,
                      comms=[bytes(x) for x in self.comms[b]],
                      proof=proofs[b].to_bytes()) for b in which]
        return self.reference.judge(items or self.inputs.items, cases,
                                    seed=SEED)

    def other_items(self) -> dict:
        """The tree's items with one leaf's value changed: another root."""
        items = dict(self.inputs.items)
        key = next(iter(items))
        items[key] = (items[key] + 1) % port.L
        return items


def flipped(proof, at: int = 64):
    raw = bytearray(proof.to_bytes())
    raw[len(raw) - at] ^= 1  # low byte of the IPP's `a` scalar
    return port.R1CSProof.from_bytes(bytes(raw))


def check_proofs(svc, proofs):
    assert [p.to_bytes() for p in proofs] == [
        p.to_bytes() for p in svc.alone()]
    assert len({p.to_bytes() for p in proofs}) == B


def check_reference_accepts(svc, proofs):
    got = svc.judged(proofs, range(B))
    assert got["proofs_rejected"] == 0 and got["commitments_differ"] == 0


def check_flipped(svc, proofs, k):
    bad = list(proofs)
    bad[k] = flipped(proofs[k])
    assert svc.verdict(bad) == [k]
    alone = [svc.judged(bad, [b])["proofs_rejected"] for b in range(B)]
    assert alone == [int(b == k) for b in range(B)]


def check_other_root(svc, proofs):
    assert svc.verdict(proofs, root_shift=1) == list(range(B))
    other = svc.other_items()
    assert [svc.judged(proofs, [b], other)["proofs_rejected"]
            for b in range(B)] == [1] * B


@pytest.fixture(autouse=True)
def clean_recorder():
    metrics.disable()
    metrics.take()
    yield
    metrics.disable()
    metrics.take()


@pytest.fixture(scope="module")
def service():
    svc = Service(Staged(), 2)
    return svc, svc.prove()


def test_batched_proofs_equal_each_prover_proved_alone(service):
    check_proofs(*service)


def test_the_reference_accepts_each_batched_proof(service):
    check_reference_accepts(*service)


def test_batch_verify_accepts_the_honest_batch(service):
    svc, proofs = service
    assert svc.verdict(proofs) is None


def test_a_flipped_byte_is_refused_and_named(service):
    check_flipped(*service, k=1)


def test_a_batch_against_another_root_is_refused(service):
    check_other_root(*service)


def _batch_rows(spans) -> list:
    """The ``device_rows`` of each ``msm_gens`` directly under a
    ``batch_verify``."""
    tops = {s.id for s in spans if s.name == "batch_verify"}
    return [s.counts["device_rows"] for s in spans
            if s.name == "msm_gens" and s.parent in tops]


@pytest.fixture(scope="module")
def two_phase():
    """B two-phase proofs of one statement (41 phase-1 and 11 phase-2
    multipliers, padded to 64), each with its own blinding."""
    return [tvr.two_phase_case() for _ in range(B)]


def judge(cases, proofs, be, wrong: bool = False):
    """None where ``batch_verify`` accepts `proofs` of `cases` on `be`,
    else the indices its refusal names; with `wrong`, against each case's
    false statement."""
    try:
        batch_verify([c.wrong() if wrong else c.verifier() for c in cases],
                     proofs, tvr.PC, cases[0].gens, backend=be)
    except port.VerificationError as err:
        return named_indices(err)
    return None


def test_device_rows_accept_the_honest_batch(two_phase):
    metrics.enable()
    assert judge(two_phase, [c.proof for c in two_phase],
                 tvr.cpu_backend()) is None
    assert _batch_rows(metrics.take()) == [2 * 64]


def test_device_rows_name_a_flipped_byte(two_phase):
    bad = [c.proof for c in two_phase]
    bad[0] = flipped(bad[0])
    metrics.enable()
    assert judge(two_phase, bad, tvr.cpu_backend()) == [0]
    spans = metrics.take()
    assert _batch_rows(spans) == [2 * 64]
    (recheck,) = [s for s in spans if s.name == "batch_verify.recheck"]
    assert recheck.counts["bad"] == 1


def test_device_rows_name_every_index_against_another_root(two_phase):
    assert judge(two_phase, [c.proof for c in two_phase], tvr.cpu_backend(),
                 wrong=True) == list(range(B))


def test_device_rows_sum_a_batch_of_mixed_sizes():
    """Two-phase proofs of two padded sizes (64 and 32) on the rows
    backend: one ``gh_rows`` sums every job's rows, the smaller one's
    padded with zeros (``device_rows`` 2 x 64); the honest batch accepted
    and a flipped byte named."""
    cases = [tvr.two_phase_case(links) for links in (40, 10, 40)]
    proofs = [c.proof for c in cases]
    metrics.enable()
    assert judge(cases, proofs, tvr.cpu_backend()) is None
    bad = list(proofs)
    bad[1] = flipped(proofs[1])
    assert judge(cases, bad, tvr.cpu_backend()) == [1]
    assert _batch_rows(metrics.take()) == [2 * 64, 2 * 64]


@pytest.mark.parametrize("kind", ["mixed_sizes", "all_host"])
def test_host_rows_judge_a_batch_the_device_does_not_sum(kind):
    """Two-phase proofs of two padded sizes (64 and 32) on a rows backend
    whose walker starts above 32, so the smaller proof keeps the host's
    rows: the host sums its rows into an MSM of their own
    (``device_rows`` 0) beside the device's sum of the others (2 x 64);
    or proofs of one size on a backend whose walker starts above 64, all
    on the host.  The honest batch accepted and a flipped byte named, in
    either part."""
    sizes = [40, 10, 40] if kind == "mixed_sizes" else [40, 40, 40]
    cases = [tvr.two_phase_case(links) for links in sizes]
    be = port.TorchBackend("cpu", min_device_n=1,
                           walker_min_n=33 if kind == "mixed_sizes" else 65)
    proofs = [c.proof for c in cases]
    metrics.enable()
    assert judge(cases, proofs, be) is None
    for at in (0, 1):
        bad = list(proofs)
        bad[at] = flipped(proofs[at])
        assert judge(cases, bad, be) == [at]
    want = [0, 2 * 64] if kind == "mixed_sizes" else [0]
    assert _batch_rows(metrics.take()) == want * 3


def _small_batch(be, seeds=(31, 32, 33)):
    built = [small._prover(s) for s in seeds]
    proofs = prove_provers([p for p, _ in built], small.GENS, backend=be)
    return [c for _, c in built], proofs


def _small_verify(comms, proofs, be):
    verifiers = []
    for c in comms:
        v = port.Verifier(port.Transcript(small.LABEL))
        small._circuit(v, *(v.commit(x) for x in c))
        verifiers.append(v)
    batch_verify(verifiers, proofs, small.PC, small.GENS, backend=be)


def test_a_traced_batch_is_one_tree_and_off_records_nothing():
    be = TorchBackend("cpu", min_device_n=1)
    comms, plain = _small_batch(be)
    _small_verify(comms, plain, be)
    assert metrics.take() == []
    metrics.enable()
    try:
        comms, proofs = _small_batch(be)
        _small_verify(comms, proofs, be)
        bad = list(proofs)
        bad[2] = flipped(proofs[2])
        with pytest.raises(port.VerificationError, match=r"\[2\]"):
            _small_verify(comms, bad, be)
    finally:
        metrics.disable()
    assert [p.to_bytes() for p in proofs] == [p.to_bytes() for p in plain]
    spans = metrics.take()
    small._check_tree(spans)
    tops = sorted((s for s in spans if s.parent is None),
                  key=lambda s: s.start)
    assert [s.name for s in tops] == [
        "prove_batch", "batch_verify", "batch_verify"]
    assert all(s.counts["proofs"] == B for s in tops)
    prove, honest, refused = tops
    mine = [s for s in spans if s.proof == prove.id]
    parts = program_spans.split(prove, mine)
    wall = 1e3 * (prove.end - prove.start)
    assert min(parts["self"], parts["seam_host"], parts["device_wait"]) > 0
    assert parts["self"] + parts["seam_host"] + parts["device_wait"] == \
        pytest.approx(wall, rel=0.01)
    kids = [s.name for s in sorted(mine, key=lambda s: s.start)
            if s.parent == prove.id]
    assert kids == ["batch.state", "phase_commitments", "batch.middle",
                    "ipp_create"]
    vkids = [s.name for s in sorted(spans, key=lambda s: s.start)
             if s.parent == honest.id]
    assert vkids == ["batch_verify.jobs", "batch_verify.combine",
                     "msm_gens"]
    (recheck,) = [s for s in spans if s.parent == refused.id
                  and s.name == "batch_verify.recheck"]
    assert recheck.counts["bad"] == 1
    assert [s.name for s in spans if s.parent == recheck.id] == [
        "msm_gens"] * B


def _span(name, start, end, id_, parent, proof):
    return Span(name, start, end, id_, parent, proof, 1, {})


SYNTHETIC = [
    _span("prove_batch", 1.0, 11.0, 1, None, 1),
    _span("batch.state", 1.0, 1.5, 2, 1, 1),
    _span("phase_commitments", 1.5, 2.5, 3, 1, 1),
    _span("seam.fetch", 2.0, 2.25, 4, 3, 1),
    _span("batch.middle", 2.5, 6.0, 5, 1, 1),
    _span("ipp_create", 6.0, 10.0, 6, 1, 1),
    _span("ipp.job", 6.0, 10.0, 7, 6, 1),
    _span("seam.fetch", 7.0, 7.5, 8, 6, 1),
    _span("batch_verify", 12.0, 15.0, 9, None, 9),
    _span("batch_verify.jobs", 12.0, 14.0, 10, 9, 9),
    _span("msm_gens", 14.2, 14.7, 11, 9, 9)._replace(
        counts={"device_rows": 1 << 19}),
    _span("seam.fetch", 14.5, 14.6, 12, 11, 9),
]
EXPECTED = {"batch_self_ms.batch": 1e3 * (10.0 - 1.0 - 4.0),
            "batch_wait_ms.batch": 1e3 * (0.25 + 0.5),
            "bverify_host_ms.batch": 1e3 * (3.0 - 0.5),
            "device_rows.batch": 1 << 19}


def _trace(wall, busy):
    return types.SimpleNamespace(per_span=lambda name: (
        [(wall, busy)] if name == "prove" else []))


@pytest.mark.parametrize("reader", READERS)
def test_each_reader_reads_a_synthetic_batch(reader, monkeypatch):
    read = named.load("metrics", reader).read
    card = next(iter(counts.PEAKS))
    rec = types.SimpleNamespace(window=(0.0, 0.5), trace=_trace(9.0, 0.2),
                                device_name=card, config={"batch": B},
                                shapes={"n": 143_704, "padded": 1 << 18})
    monkeypatch.setattr(program_spans, "recorded", lambda: list(SYNTHETIC))
    want = EXPECTED.get(reader)
    if reader == "kernel_roofline.batch":
        want = 100.0 * B * counts.prove_floor_s(
            143_704, 1 << 18, counts.PEAKS[card]) / 0.2
    assert read(rec) == pytest.approx(want, rel=1e-9)
    # a program that records no batch spans (the single proof's, or none),
    # a trace with no device time: nothing to read
    single = [s._replace(name="prove") if s.name == "prove_batch" else s
              for s in SYNTHETIC if s.proof == 1]
    monkeypatch.setattr(program_spans, "recorded", lambda: single)
    rec.trace = _trace(9.0, 0.0)
    assert read(rec) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: [])
    rec.trace = None
    assert read(rec) is None


def _run(fault=None):
    cell = dict(name=CELL, config="vsmt2-d253-b8", traffic="batch", chips=1)
    rec = drive.run(cell, _config(4), TRAFFIC, SEED, 0.01, False,
                    device="cpu", fault=fault, backend=NativeBackend())
    return rec, bench.result(rec, bench.load_spec(), False, "cpu", 1)


@pytest.mark.parametrize("fault", [
    pytest.param(None, id="sound"),
    pytest.param(lambda: faults.tamper, id="tamper"),
    pytest.param(faults.Stale, id="stale"),
    pytest.param(lambda: faults.drop_half, id="drop_half"),
])
def test_the_batch_traffic_through_drive_run(fault):
    rec, out = _run(None if fault is None else fault())
    if fault is None:
        assert out["correct"], out["checked"]
        assert out["attempted"] == B * len(rec.launches) > 0
        assert out["failed"] == 0
        names = {m["name"] for m in bench.metrics_of(
            bench.load_spec(), rec.cell, False)}
        assert set(out["metrics"]) == names == {
            "prove_s", "verify_s", "setup_s"}
    else:
        assert not out["correct"], out["checked"]


@pytest.mark.cuda
def test_the_batch_service_on_the_card():
    """The checks above through ``TorchBackend("cuda")`` at depth 4 (the
    grid route, the flotilla's ``msm_lane``), the reference on the card,
    and the batch's spans on the card's seam."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    svc = Service(TorchBackend("cuda", route=Route()), 4, device="cuda")
    before = cc.LAUNCHES["msm_lane"]
    metrics.enable()
    try:
        proofs = svc.prove()
        assert svc.verdict(proofs) is None
    finally:
        metrics.disable()
    assert cc.LAUNCHES["msm_lane"] > before
    spans = metrics.take()
    (top,) = [s for s in spans if s.parent is None and s.name == "prove_batch"]
    parts = program_spans.split(top, [s for s in spans if s.proof == top.id])
    assert min(parts["self"], parts["seam_host"], parts["device_wait"]) > 0
    assert parts["self"] + parts["seam_host"] + parts["device_wait"] == \
        pytest.approx(1e3 * (top.end - top.start), rel=0.01)
    (vtop,) = [s for s in spans if s.parent is None
               and s.name == "batch_verify"]
    assert [s.name for s in spans if s.parent == vtop.id].count(
        "msm_gens") == 1
    check_proofs(svc, proofs)
    check_reference_accepts(svc, proofs)
    check_flipped(svc, proofs, k=2)
    check_other_root(svc, proofs)
