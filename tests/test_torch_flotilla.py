"""The port's flotilla (``msm_lane``) and batched proving / verification.

* ``msm_lane``'s plain version against the JAX package's TPU kernel
  ``msm_lane_dyn``, run once under ``pallas_call(interpret=True)`` at two
  2048-point chunks (as tests/test_kernel_flags_interpret.py runs it), on
  the same generators and scalars.
* The flotilla's segment layout (``flotilla_pack`` / ``flotilla_words``)
  with frozen packs of different sizes.
* ``prove_provers`` through ``TorchBackend`` on a batch of three provers
  of two circuits, against the JAX package's host engine's sequential
  proofs, with the flotilla rounds counted, and on the combined IPP
  route (its threshold lowered) for a mixed batch; ``batch_verify``
  through the port accepts the batch and rejects it with one tampered
  proof.

CPU tensors route to the kernels' plain versions.  The port's provers are
built from the port's objects, the references from the JAX package's.
Tolerance: exact (equal points, equal bytes).
"""

import functools

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu import BulletproofGens as JBulletproofGens
from bulletproofs_r1cs_gadgets_tpu.ops import chunks as jck
from bulletproofs_r1cs_gadgets_tpu.ops import pallas_curve as pc
from bulletproofs_r1cs_gadgets_tpu.utils.constants import L
from bulletproofs_r1cs_gadgets_tpu_torch import (
    BulletproofGens,
    PedersenGens,
    R1CSProof,
    Scalar,
    TorchBackend,
    VerificationError,
    batch_verify,
    multiscalar_mul,
    prove_provers,
    scvec,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F
from bulletproofs_r1cs_gadgets_tpu_torch.ops import torch_backend as tb
from bulletproofs_r1cs_gadgets_tpu_torch.ops.torch_backend import WALKER_MIN_N
from test_torch_backend import (
    CIRCUITS,
    COMB_CHUNK,
    COMB_KERNELS,
    count_calls,
)

# The plain versions run many small tensor ops: intra-op threads gain
# nothing there and contend with the other test workers' processes.
torch.set_num_threads(1)

GENS = BulletproofGens(256)  # one generator set serves the whole batch
# padded to 64, 64 and 256 multipliers: frozen packs of different sizes
BATCH = [("chain33", 0), ("bound", 0), ("chain129", 0)]


def _rows(n: int, seed: int) -> np.ndarray:
    rows = scvec.from_wide_bytes(np.random.RandomState(seed).bytes(64 * n))
    rows[:3] = scvec.from_ints([0, 1, L - 1])
    return rows


@pytest.fixture(scope="module")
def jax_lane(request):
    """ONE interpret-mode run of the TPU flotilla kernel: two independent
    2048-point totals over the first 4096 generators."""
    from jax.experimental import pallas as pl

    from bulletproofs_r1cs_gadgets_tpu.ops.pallas_backend import PallasBackend

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    pc.msm_lane_dyn.clear_cache()

    def fin():
        pl.pallas_call = orig
        pc.msm_lane_dyn.clear_cache()

    request.addfinalizer(fin)
    n = 2 * jck.CHUNK
    share = JBulletproofGens(n).share(0)
    big = PallasBackend()._gens_big(share, n, "G")
    rows = _rows(n, 7)
    block = jck.msm_lane(big, jck.grid_words(rows, 2), 2)
    return {
        "share": share, "rows": rows, "n": n,
        "totals": jck.fetch_lane_points(block, 2),
    }


@pytest.mark.kernelmath
def test_msm_lane_plain_matches_tpu_kernel(jax_lane):
    d = jax_lane
    got = cc.msm_lane(
        F.from_raw(d["share"].G_raw(d["n"])), ck.w4_words(d["rows"], "cpu"), 2
    )
    assert ([p.compress() for p in F.to_points(got)]
            == [p.compress() for p in d["totals"]])


def _points(n: int, seed: int):
    B = PedersenGens.default().B
    rng = np.random.RandomState(seed)
    return [B.scalar_mul(Scalar(int(rng.randint(1, 1 << 30))))
            for _ in range(n)]


def test_msm_lane_segments_match_host():
    """Three segments of five points; the middle one has zero words."""
    pts = _points(15, 1)
    rows = _rows(15, 2)
    words = ck.w4_words(rows, "cpu")
    words[5:10] = 0
    got = F.to_points(cc.msm_lane(F.from_points(pts), words, 3))
    sc = scvec.to_scalars(rows)
    assert got[0] == multiscalar_mul(sc[:5], pts[:5])
    assert got[1].is_identity()
    assert got[2] == multiscalar_mul(sc[10:], pts[10:])
    with pytest.raises(ValueError):
        cc.msm_lane(F.from_points(pts), words, 4)


def test_flotilla_layout_with_mixed_frozen_sizes():
    """Job j's pack [G(S_j) | H(S_j)] sits, identity padded to the batch's
    largest pack, at segments 2j (L words) and 2j+1 (R words)."""
    pts = F.from_points(_points(6, 3))
    G, H = pts[:3], pts[3:]
    packs = [ck.frozen_pack(G, H, 2), ck.frozen_pack(G, H, 3)]
    seg = 6
    flot = ck.flotilla_pack(packs, seg)
    assert flot.shape == (4 * seg, 4, 8)
    pairs = [(_rows(4, 4), _rows(4, 5)), (_rows(6, 6), _rows(6, 7))]
    words = ck.flotilla_words(pairs, seg, "cpu")
    assert words.shape == (4 * seg, 8)
    for j, (pack, rows_lr) in enumerate(zip(packs, pairs)):
        m = pack.shape[0]
        for side in (0, 1):
            s = (2 * j + side) * seg
            assert torch.equal(flot[s : s + m], pack)
            assert torch.equal(flot[s + m : s + seg],
                               F.identity_points(seg - m))
            assert torch.equal(words[s : s + m],
                               ck.w4_words(rows_lr[side], "cpu"))
            assert not words[s + m : s + seg].any()
    totals = F.to_points(cc.msm_lane(flot, words, 4))
    for j, (pack, rows_lr) in enumerate(zip(packs, pairs)):
        for side in (0, 1):
            assert totals[2 * j + side] == multiscalar_mul(
                scvec.to_scalars(rows_lr[side]), F.to_points(pack)
            )


def _batch(pkg: str = "port"):
    built = [CIRCUITS[name].build(seed, pkg=pkg) for name, seed in BATCH]
    return [c for c, _ in built], [p for _, p in built]


@pytest.fixture(scope="module")
def host_batch():
    """The JAX package's host-engine proofs of the batch, one prover at a
    time."""
    comms, provers = _batch("jax")
    return comms, [p.prove(JBulletproofGens(256)) for p in provers]


# frozen-from-round-1: every job is frozen from the start (S = 64, 64 and
# 256), so rounds 1-6 are flotilla rounds over three jobs and chain129's
# last two rounds run msm_w4_pair alone.  w5-then-freeze: chain129's
# round 1 walks the w5 tables and it freezes at S = 64 after round 3 (two
# fold_bits rounds); the other two, frozen from round 1, take msm_w4_pair
# until then, and rounds 4-6 are flotilla rounds.
@pytest.mark.parametrize("max_side, walker_min_n, lane_rounds", [
    pytest.param(1024, WALKER_MIN_N, 6, id="frozen-from-round-1"),
    pytest.param(64, 1, 3, id="w5-then-freeze"),
])
def test_prove_provers_matches_host_sequential(
    host_batch, max_side, walker_min_n, lane_rounds, monkeypatch
):
    lanes = []
    lane = cc.msm_lane
    monkeypatch.setattr(
        cc, "msm_lane", lambda *a: lanes.append(a[2]) or lane(*a)
    )
    comms_ref, ref = host_batch
    comms, provers = _batch()
    backend = TorchBackend("cpu", min_device_n=1, frozen_max_side=max_side,
                           walker_min_n=walker_min_n)
    proofs = prove_provers(provers, GENS, backend=backend, host_workers=1)
    assert comms == comms_ref
    assert [p.to_bytes() for p in proofs] == [p.to_bytes() for p in ref]
    assert lanes == [2 * len(BATCH)] * lane_rounds


def test_prove_provers_combined_route_matches_host(host_batch, monkeypatch):
    """The mixed batch (64, 64 and 256 padded multipliers) with the
    combined layout's threshold lowered: every job takes the round-1
    transition and the combined rounds (2, 2 and 4 of them) in lockstep
    before the tail; the bytes equal the host engine's."""
    monkeypatch.setattr(tb, "COMB_MIN_N", COMB_CHUNK)
    calls = count_calls(monkeypatch, COMB_KERNELS)
    comms_ref, ref = host_batch
    comms, provers = _batch()
    backend = TorchBackend("cpu", min_device_n=1, frozen_max_side=4,
                           walker_min_n=1)
    proofs = prove_provers(provers, GENS, backend=backend, host_workers=1)
    assert comms == comms_ref
    assert [p.to_bytes() for p in proofs] == [p.to_bytes() for p in ref]
    rounds = 2 + 2 + 4
    assert calls == {"fold_w3h": 2 * len(BATCH), "table_w4": rounds,
                     "msm_win_pair": rounds, "fold_w3h_comb": rounds}
    pc_gens = PedersenGens.default()
    batch_verify(_verifiers(comms), proofs, pc_gens, GENS, backend=backend)
    raw = bytearray(proofs[2].to_bytes())
    raw[len(raw) - 64] ^= 1  # low byte of the IPP's `a` scalar
    bad = proofs[:2] + [R1CSProof.from_bytes(bytes(raw))]
    with pytest.raises(VerificationError, match=r"\[2\]"):
        batch_verify(_verifiers(comms), bad, pc_gens, GENS, backend=backend)


def _verifiers(comms):
    return [CIRCUITS[name].verifier(c) for (name, _), c in zip(BATCH, comms)]


def test_batch_verify_through_port(host_batch):
    comms, proofs = host_batch
    proofs = [R1CSProof.from_bytes(p.to_bytes()) for p in proofs]
    backend = TorchBackend("cpu", min_device_n=1, walker_min_n=1)
    pc_gens = PedersenGens.default()
    batch_verify(_verifiers(comms), proofs, pc_gens, GENS, backend=backend)
    raw = bytearray(proofs[1].to_bytes())
    raw[len(raw) - 64] ^= 1  # low byte of the IPP's `a` scalar
    bad = list(proofs)
    bad[1] = R1CSProof.from_bytes(bytes(raw))
    with pytest.raises(VerificationError, match=r"\[1\]"):
        batch_verify(_verifiers(comms), bad, pc_gens, GENS, backend=backend)


def test_launch_counts_survive_concurrent_launches():
    """Batched IPP rounds launch from a thread pool: the launch counter's
    read-modify-write must not lose updates (32 threads, tiny switch
    interval)."""
    import sys
    import threading

    def bump():
        for _ in range(2000):
            cc._count("msm_lane")

    before = cc.LAUNCHES["msm_lane"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert cc.LAUNCHES["msm_lane"] - before == 32 * 2000
