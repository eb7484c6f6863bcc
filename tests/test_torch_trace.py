"""The port's span recorder (``utils/metrics.py``) inside the prover, the
verifier and ``TorchBackend``'s seam, on the CPU (the kernels' plain
versions), and the benchmark's readers of it (``benchmark/program_spans``,
``benchmark/metrics/*``).

A proof of a small circuit (8 multipliers padded, so three IPP rounds:
the walker round 1 over the shared tables, a chunk-list round and a
frozen round) must give one tree of spans: each inside its parent, all of
one proof id, the prove's children covering it, the readers' three parts
adding up to it; its bytes equal with recording off, when nothing is
recorded; the ``h2d_bytes`` counts equal the bytes uploaded.  Two provers
on two threads, and a batch through ``ipp_create_batch``'s pool, give
disjoint trees.  A traced CPU run of ``benchmark.drive`` reads every
new metric, and the program's spans lie inside the benchmark's on the
same clock.  Tolerance: exact (bytes, counts, ids); the children cover
the prove to within 1 ms of gaps; the parts add up to 1e-9 relative.
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

import bulletproofs_r1cs_gadgets_tpu_torch as port
from benchmark import drive, named, program_spans
from benchmark import run as bench
from bulletproofs_r1cs_gadgets_tpu_torch import Route, TorchBackend
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field
from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import (
    NativeBackend)
from bulletproofs_r1cs_gadgets_tpu_torch.utils import metrics

torch.set_num_threads(1)

PC = port.PedersenGens.default()
GENS = port.BulletproofGens(8)
LABEL = b"Trace"
PROVE_CHILDREN = ["prove.state", "phase_commitments", "prove.phase2",
                  "prove.flatten", "prove.polys", "prove.ipp_inputs",
                  "ipp_create"]
NEW_METRICS = ("engine_self_ms.prove", "seam_host_ms.prove",
               "device_wait_ms.prove", "upload_mb.prove",
               "verify_host_ms.verify")


def _backend(**kw):
    return TorchBackend("cpu", min_device_n=1, walker_min_n=1,
                        frozen_max_side=4, **kw)


def _circuit(cs, a, b):
    _, _, o = cs.multiply(a, b)
    for _ in range(7):
        _, _, o = cs.multiply(o + port.Scalar(1), o + port.Scalar(2))


def _prover(seed):
    pr = port.Prover(PC, port.Transcript(LABEL),
                     rng=np.random.RandomState(seed))
    cp, vp = pr.commit(port.Scalar(17), port.Scalar(5))
    cq, vq = pr.commit(port.Scalar(19), port.Scalar(6))
    _circuit(pr, vp, vq)
    return pr, (cp, cq)


def _verify(comms, proof, backend):
    ve = port.Verifier(port.Transcript(LABEL))
    _circuit(ve, *(ve.commit(c) for c in comms))
    ve.verify(proof, PC, GENS, backend=backend)


@pytest.fixture(autouse=True)
def clean_recorder():
    metrics.disable()
    metrics.take()
    yield
    metrics.disable()
    metrics.take()


@pytest.fixture(scope="module")
def traced_proof():
    """A proof and its verification with recording off, then the same
    proof recorded, its uploads counted by a spy on ``field.upload``."""
    metrics.disable()
    metrics.take()
    be = _backend()
    pr, comms = _prover(7)
    plain = pr.prove(GENS, backend=be)
    _verify(comms, plain, be)
    off = metrics.take()
    uploaded = []
    upload = field.upload

    def spy(arr, device):
        uploaded.append(arr.nbytes)
        return upload(arr, device)

    field.upload = spy
    metrics.enable()
    try:
        t0 = time.perf_counter()
        pr, comms = _prover(7)
        proof = pr.prove(GENS, backend=be)
        n_uploads = len(uploaded)
        _verify(comms, proof, be)
    finally:
        metrics.disable()
        field.upload = upload
    return types.SimpleNamespace(
        plain=plain, proof=proof, off=off, spans=metrics.take(), t0=t0,
        uploaded=uploaded[:n_uploads])


def _tops(spans, name):
    return [s for s in spans if s.name == name and s.parent is None]


def _check_tree(spans):
    """Every span lies inside its parent and shares its proof id."""
    by = {s.id: s for s in spans}
    for s in spans:
        assert s.start <= s.end, s
        if s.parent is None:
            assert s.proof == s.id, s
            continue
        p = by[s.parent]
        assert p.start <= s.start and s.end <= p.end, (p, s)
        assert s.proof == p.proof, (p, s)


def test_recording_off_records_nothing_and_keeps_the_bytes(traced_proof):
    assert traced_proof.off == []
    assert traced_proof.proof.to_bytes() == traced_proof.plain.to_bytes()


def test_a_proof_is_one_tree_covered_by_its_phases(traced_proof):
    spans = traced_proof.spans
    _check_tree(spans)
    (prove,) = _tops(spans, "prove")
    (verify,) = _tops(spans, "verify")
    assert len([s for s in spans if s.parent is None]) == 2
    mine = [s for s in spans if s.proof == prove.id]
    kids = sorted((s for s in mine if s.parent == prove.id),
                  key=lambda s: s.start)
    assert [s.name for s in kids] == PROVE_CHILDREN
    for a, b in zip(kids, kids[1:]):
        assert a.end <= b.start
    gaps = (prove.end - prove.start) - sum(s.end - s.start for s in kids)
    assert 0 <= gaps < 1e-3
    # the IPP's rounds, each with its host step, its sync and its finish
    rounds = sorted((s for s in mine if s.name == "ipp.round"),
                    key=lambda s: s.start)
    assert [(s.counts["round"], s.counts["m"]) for s in rounds] == [
        (1, 4), (2, 2), (3, 1)]
    for r in rounds:
        names = {s.name for s in mine if s.parent == r.id}
        assert names == {"ipp.scalars", "seam.encode", "seam.launch",
                         "seam.fetch", "ipp.finish"}, names
    # the readers' three parts add up to the prove
    parts = program_spans.split(prove, mine)
    assert min(parts["self"], parts["seam_host"], parts["device_wait"]) > 0
    assert parts["self"] + parts["seam_host"] + parts["device_wait"] == \
        pytest.approx(1e3 * (prove.end - prove.start), rel=1e-9)
    vkids = sorted((s for s in spans if s.parent == verify.id),
                   key=lambda s: s.start)
    assert [s.name for s in vkids] == ["verify.scalars", "msm_gens"]
    assert program_spans.split(verify, spans)["self"] == pytest.approx(
        1e3 * (verify.end - verify.start - (vkids[1].end - vkids[1].start)),
        rel=1e-9)


def test_h2d_bytes_count_every_upload(traced_proof):
    (prove,) = _tops(traced_proof.spans, "prove")
    counted = sum(s.counts.get("h2d_bytes", 0) for s in traced_proof.spans
                  if s.proof == prove.id)
    assert traced_proof.uploaded and counted == sum(traced_proof.uploaded)
    # every copy to the device in the encoders and codecs goes through it
    ops = os.path.dirname(field.__file__)
    for name in ("chunks.py", "field.py"):
        with open(os.path.join(ops, name)) as f:
            src = f.read()
        assert "as_tensor(" not in src and src.count("torch.from_numpy(") \
            == (1 if name == "field.py" else 0), name


def test_the_readers_read_a_traced_proof(traced_proof, monkeypatch):
    monkeypatch.setattr(program_spans, "recorded",
                        lambda: list(traced_proof.spans))
    rec = types.SimpleNamespace(window=(traced_proof.t0, traced_proof.t0))
    got = {m: named.load("metrics", m).read(rec) for m in NEW_METRICS}
    (prove,) = _tops(traced_proof.spans, "prove")
    assert got["engine_self_ms.prove"] + got["seam_host_ms.prove"] + \
        got["device_wait_ms.prove"] == pytest.approx(
            1e3 * (prove.end - prove.start), rel=1e-9)
    assert got["upload_mb.prove"] == sum(traced_proof.uploaded) / 1e6
    assert all(v > 0 for v in got.values()), got
    # nothing recorded after the window: nothing to read
    late = types.SimpleNamespace(window=(0.0, time.perf_counter()))
    assert all(named.load("metrics", m).read(late) is None
               for m in NEW_METRICS)


def test_only_the_newest_spans_are_kept():
    """A run that records and never takes holds at most ``KEEP`` spans,
    the newest."""
    metrics.enable()
    for i in range(metrics.KEEP + 10):
        with metrics.span(f"s{i}", root=True):
            pass
    metrics.disable()
    kept = metrics.spans()
    assert len(kept) == metrics.KEEP
    assert kept[0].name == "s10" and kept[-1].name == f"s{metrics.KEEP + 9}"
    assert len(metrics.take()) == metrics.KEEP and not metrics.spans()


def _disjoint(spans, roots):
    """The trees under `roots` hold every span, one proof id each."""
    _check_tree(spans)
    assert sorted(s.id for s in spans if s.parent is None) == sorted(
        r.id for r in roots)
    assert len({r.proof for r in roots}) == len(roots)


def test_two_provers_on_two_threads_give_two_trees():
    be = _backend()
    provers = [_prover(seed)[0] for seed in (11, 12)]
    out = [None, None]

    def prove(i):
        out[i] = provers[i].prove(GENS, backend=be)

    metrics.enable()
    threads = [threading.Thread(target=prove, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    metrics.disable()
    assert not any(t.is_alive() for t in threads) and all(out)
    spans = metrics.take()
    tops = _tops(spans, "prove")
    assert len(tops) == 2 and tops[0].thread != tops[1].thread
    _disjoint(spans, tops)
    for top in tops:
        mine = [s for s in spans if s.proof == top.id]
        assert {s.name for s in mine if s.parent == top.id} == set(
            PROVE_CHILDREN)


@pytest.mark.parametrize("flotilla", [True, False])
def test_a_batch_gives_a_tree_per_proof(flotilla):
    """Through ``prove_provers``: one ``phase_commitments`` for the batch,
    then one ``ipp_create`` tree per proof, whose steps ran on the
    pool's threads (the flotilla's shared launch in every tree)."""
    be = TorchBackend("cpu", min_device_n=1, route=Route(flotilla=flotilla))
    provers = [_prover(seed)[0] for seed in (21, 22)]
    metrics.enable()
    try:
        proofs = port.prove_provers(provers, GENS, backend=be)
    finally:
        metrics.disable()
    assert len(proofs) == 2
    spans = metrics.take()
    roots = [s for s in spans if s.parent is None]
    assert sorted(s.name for s in roots) == [
        "ipp_create", "ipp_create", "phase_commitments"]
    _disjoint(spans, roots)
    for root in _tops(spans, "ipp_create"):
        rounds = [s for s in spans if s.parent == root.id]
        assert [s.counts["round"] for s in rounds] == [1, 2, 3]
        for r in rounds:
            kids = {s.name for s in spans if s.parent == r.id}
            assert kids == {"ipp.scalars", "seam.encode", "seam.launch",
                            "seam.fetch", "ipp.finish"}, kids


def test_a_traced_benchmark_run_reads_the_program_spans():
    """The single traffic at depth 1 on the host backend (the seam spans
    are ``TorchBackend``'s, so its seam readers read 0)."""
    root = bench.ROOT
    with open(os.path.join(root, "benchmark", "configs",
                           "vsmt2-d253.json")) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", "single.json")) as f:
        traffic = json.load(f)
    config = dict(config, depth=1, tree_updates=2, generators=1024)
    traffic = dict(traffic, provers=1, check=1)
    cell = dict(name="vsmt2-d253.single", config="vsmt2-d253",
                traffic="single", chips=1)
    rec = drive.run(cell, config, traffic, 2**31 + 977, 0.1, True,
                    device="cpu", backend=NativeBackend())
    out = bench.result(rec, bench.load_spec(), True, "cpu", 1)
    assert out["correct"], out["checked"]
    for name in ("prove", "verify"):
        ours = program_spans.traced(rec, name)
        theirs = rec.spans.of(name, rec.window[1])
        assert len(ours) == len(theirs) == traffic["traced_steps"]
        for (top, _), (_, a, b, _, _) in zip(
                sorted(ours, key=lambda t: t[0].start), sorted(
                    theirs, key=lambda s: s[1])):
            assert a <= top.start and top.end <= b
    got = out["metrics"]
    assert all(m in got for m in NEW_METRICS), sorted(got)
    assert got["engine_self_ms.prove"]["value"] > 0
    assert got["verify_host_ms.verify"]["value"] > 0
    assert got["upload_mb.prove"]["value"] == 0
    assert "device_idle.prove" not in got
    assert "kernel_roofline.prove" not in got
