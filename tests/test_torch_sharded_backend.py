"""The port's sharded oracle backend, sharded step and dry run on CPU
devices, against the JAX package.

The JAX package's own sharded backend and step are multi-minute
``shard_map`` compiles on its CPU mesh (``mesh_slow``), so the oracles are
its host path (``backend=None``), the host ``multiscalar_mul`` and the host
Poseidon chain:

* ``scalars_to_digits`` equals the JAX function on ints and on scvec
  rows; ``msm_chunk_impl`` at windows 1, 2 and 4 equals the host MSM,
  and its digits pack back into the kernel's bit words;
* ``ShardedMsmBackend(["cpu"] * 4, min_device_n=1)`` proves a small
  bound check byte-equal to the JAX host path (every MSM over the four
  shards, each partial added with ``padd``) and verifies it, and rejects
  a tampered copy;
* ``BatchShardedBackend`` on a (2, 2) CPU mesh proves two same-shape
  proofs in lockstep, byte-equal to the JAX host path; the host verifies
  each, one combined ``verify_batch`` runs through the backend, swapped
  commitments are rejected, and a heterogeneous batch falls back to the
  per-job path (dry run B2);
* ``make_sharded_step`` on the (2, 2) mesh equals the host Poseidon chain,
  their sum mod l and the host MSM, and the port's ``proving_step``
  (tests/test_parallel.py:186's sizes).

The dry run that drives these backends is tests/test_torch_graft_entry.py.

CPU tensors run the kernels' plain versions.  Tolerance: exact (equal
digits, points and proof bytes).
"""

import secrets

import numpy as np
import pytest
import torch

import bulletproofs_r1cs_gadgets_tpu as jaxpkg
import bulletproofs_r1cs_gadgets_tpu_torch as port
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import (
    multiscalar_mul as jmultiscalar_mul,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets import bound_check as jbound
from bulletproofs_r1cs_gadgets_tpu.gadgets import r1cs_utils as jutils
from bulletproofs_r1cs_gadgets_tpu.ops import msm as jmsm
from bulletproofs_r1cs_gadgets_tpu_torch import scvec
from bulletproofs_r1cs_gadgets_tpu_torch.gadgets import bound_check as tbound
from bulletproofs_r1cs_gadgets_tpu_torch.gadgets import r1cs_utils as tutils
from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.poseidon import (
    Poseidon_hash_2,
    SboxType,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import msm as M
from bulletproofs_r1cs_gadgets_tpu_torch.ops.curve import (
    points_from_device,
    points_to_device,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops.field import FQ
from bulletproofs_r1cs_gadgets_tpu_torch.parallel import pipeline
from bulletproofs_r1cs_gadgets_tpu_torch.parallel import sharded_backend as SB
from bulletproofs_r1cs_gadgets_tpu_torch.parallel.batch import prove_provers
from bulletproofs_r1cs_gadgets_tpu_torch.parallel.mesh import make_mesh

L = port.L
rng = np.random.RandomState(2026)


def _host_points(n):
    base = port.RistrettoPoint.basepoint()
    return [base.scalar_mul(port.Scalar(int(k)))
            for k in rng.randint(1, 1 << 30, size=n)]


def _count(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        orig = getattr(cc, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(cc, name, wrapped)
    return calls


@pytest.mark.parametrize("window", [1, 2, 3, 4, 8])
def test_scalars_to_digits_matches_jax(window):
    ks = [0, 1, L - 1] + [int(x) for x in rng.randint(0, 1 << 62, size=5)]
    ks += [int.from_bytes(rng.bytes(32), "little") % L for _ in range(8)]
    want = jmsm.scalars_to_digits(ks, window)
    assert np.array_equal(M.scalars_to_digits(ks, window), want)
    rows = scvec.from_ints(ks)
    if 8 % window == 0:
        assert np.array_equal(M.scalars_to_digits(rows, window), want)
        assert np.array_equal(jmsm.scalars_to_digits(rows, window), want)
    # the digits pack back into the kernel's bit words
    assert np.array_equal(M.digits_to_words(want, window), ck.bit_words(rows))


def test_digits_to_words_refuses_values_past_bit_252():
    d = np.zeros((1, 64), np.int32)
    d[0, 63] = 2  # 2^253
    with pytest.raises(ValueError):
        M.digits_to_words(d, 4)
    with pytest.raises(ValueError):
        M.digits_to_words(np.full((1, 64), 16, np.int32), 4)


@pytest.mark.parametrize("window", [1, 2, 4])
def test_msm_chunk_impl_matches_host_msm(window, monkeypatch):
    n = 40
    pts = _host_points(n)
    ks = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n)]
    ks[:2] = [0, L - 1]
    calls = _count(monkeypatch, ["msm_chunk_acc"])
    digits = M.scalars_to_digits(ks, window)
    got = M.msm_chunk_impl(points_to_device(pts, "cpu"),
                           torch.from_numpy(digits), window)
    assert got.shape == (4, 8)
    want = port.multiscalar_mul([port.Scalar(k) for k in ks], pts)
    assert points_from_device(got)[0] == want
    assert calls["msm_chunk_acc"] == 1


# ------------------------------------------------------- proofs
LOWER, UPPER, BITS = 10, 20, 4  # 8 multipliers
PC_T, PC_J = port.PedersenGens.default(), jaxpkg.PedersenGens.default()
GENS_T, GENS_J = port.BulletproofGens(64), jaxpkg.BulletproofGens(64)


@pytest.fixture
def seed_secrets(monkeypatch):
    def reset(seed: int):
        r = np.random.RandomState(seed)
        monkeypatch.setattr(secrets, "token_bytes", lambda n: r.bytes(n))

    return reset


def test_sharded_backend_proof_matches_jax_host(monkeypatch, seed_secrets):
    """Every MSM (>= 1 point) of prover and verifier over four CPU
    shards: the proof bytes equal the JAX host path's."""
    seed_secrets(5)
    jproof, jcomms = jbound.gen_proof_of_bounded_num(
        15, None, LOWER, UPPER, BITS, b"BoundsTest", PC_J, GENS_J)
    backend = SB.ShardedMsmBackend(["cpu"] * 4, min_device_n=1)
    assert backend.n_shards == 4 and backend.device == torch.device("cpu")
    sharded = []
    orig = backend._launch_sharded
    monkeypatch.setattr(backend, "_launch_sharded", lambda *a: sharded.append(
        a[2].shape[0]) or orig(*a))
    calls = _count(monkeypatch, ["msm_chunk_acc", "padd"])
    seed_secrets(5)
    proof, comms = tbound.gen_proof_of_bounded_num(
        15, None, LOWER, UPPER, BITS, b"BoundsTest", PC_T, GENS_T,
        backend=backend)
    assert comms == jcomms
    assert proof.to_bytes() == jproof.to_bytes()
    # each MSM: one launch per shard holding points (slices of ceil(n / 4)
    # points), 3 gathered adds
    assert calls["padd"] == 3 * len(sharded)
    assert calls["msm_chunk_acc"] == sum(-(-n // -(-n // 4)) for n in sharded)
    assert max(sharded) > 4
    tbound.verify_proof_of_bounded_num(
        LOWER, UPPER, BITS, proof, comms, b"BoundsTest", PC_T, GENS_T,
        backend=backend)
    raw = bytearray(proof.to_bytes())
    raw[len(raw) - 64] ^= 1
    with pytest.raises(port.VerificationError):
        tbound.verify_proof_of_bounded_num(
            LOWER, UPPER, BITS, port.R1CSProof.from_bytes(bytes(raw)), comms,
            b"BoundsTest", PC_T, GENS_T, backend=backend)


def _bound_circuit(P, utils, bound, bits, upper):
    """A bound check [0, upper] over `bits` bits as build(cs, w): w is
    (value, blinding rng) on the prover side, the commitments on the
    verifier's."""
    def build(cs, w):
        if isinstance(cs, P.Prover):
            val, r = w
            comms, qs = [], []
            for x in (val, val, upper - val):
                com, var = cs.commit(P.Scalar(x), P.Scalar.random(r))
                comms.append(com)
                qs.append(utils.AllocatedQuantity(var, x))
        else:
            comms = w
            qs = [utils.AllocatedQuantity(cs.commit(c)) for c in comms]
        bound.bound_check_gadget(cs, *qs, upper, 0, bits)
        return comms

    return build


def _provers(P, utils, bound, specs, label=b"BatchDP"):
    """Seeded provers: specs of (bits, value)."""
    provers, comms = [], []
    for i, (bits, val) in enumerate(specs):
        p = P.Prover(P.PedersenGens.default(), P.Transcript(label),
                     rng=np.random.RandomState(100 + i))
        build = _bound_circuit(P, utils, bound, bits, (1 << bits) - 1)
        comms.append(build(p, (val, np.random.RandomState(200 + i))))
        provers.append(p)
    return provers, comms


def test_batch_sharded_backend_lockstep_and_fallback(monkeypatch):
    mesh = make_mesh(devices=["cpu"] * 4, batch_axis=2)
    backend = SB.BatchShardedBackend(mesh, min_device_n=16)
    assert backend.n_batch == 2 and backend.n_shards == 2
    per_job = []
    monkeypatch.setattr(backend, "ipp_create",
                        lambda *a: per_job.append(a[5]) or
                        SB.ShardedMsmBackend.ipp_create(backend, *a))
    specs = [(8, 200), (8, 9)]
    provers, comms = _provers(port, tutils, tbound, specs)
    jprovers, jcomms = _provers(jaxpkg, jutils, jbound, specs)
    calls = _count(monkeypatch, ["fold_grid"])
    proofs = prove_provers(provers, GENS_T, backend=backend)
    assert per_job == []  # lockstep: no per-job IPP
    rounds = len(proofs[0].ipp_proof.L_vec)
    assert calls["fold_grid"] == 2 * 2 * rounds  # each job's G and H
    assert comms == jcomms
    for pf, jp in zip(proofs, jprovers):
        assert pf.to_bytes() == jp.prove(GENS_J).to_bytes()

    def verifiers(cms):
        out = []
        for (bits, _), c in zip(specs, cms):
            v = port.Verifier(port.Transcript(b"BatchDP"))
            _bound_circuit(port, tutils, tbound, bits, (1 << bits) - 1)(v, c)
            out.append(v)
        return out

    for v, pf in zip(verifiers(comms), proofs):
        v.verify(pf, PC_T, GENS_T)
    port.batch_verify(verifiers(comms), proofs, PC_T, GENS_T, backend=backend)
    swapped = verifiers([comms[1], comms[0]])
    with pytest.raises(port.VerificationError):
        swapped[0].verify(proofs[0], PC_T, GENS_T)

    # B2: an 8-bit and a 4-bit circuit cannot run in lockstep
    het = [(8, 77), (4, 3)]
    hprovers, _ = _provers(port, tutils, tbound, het, b"Het")
    jhet, _ = _provers(jaxpkg, jutils, jbound, het, b"Het")
    got = prove_provers(hprovers, GENS_T, backend=backend)
    assert per_job == [16, 8]
    for pf, jp in zip(got, jhet):
        assert pf.to_bytes() == jp.prove(GENS_J).to_bytes()


def test_make_sharded_step_matches_host_oracles():
    """B = 2 proofs of W = 3 lanes, N = 8 points x 16 bits on the (2, 2)
    CPU mesh (tests/test_parallel.py:186)."""
    B, W, N, NBITS = 2, 3, 8, 16
    vals = [[3 * i + j + 1 for j in range(W)] for i in range(B)]
    witness = FQ.to_device([v for r in vals for v in r], "cpu").reshape(B, W, 8)
    pts = _host_points(N)
    ks = [int(k) for k in rng.randint(1, 1 << 15, size=N)]
    bits = torch.tensor([[(k >> b) & 1 for b in range(NBITS)] for k in ks],
                        dtype=torch.int32)
    points = points_to_device(pts, "cpu")
    mesh = make_mesh(devices=["cpu"] * 4, batch_axis=2)
    digest, checksum, total = pipeline.make_sharded_step(mesh)(
        witness, points, bits)
    params = pipeline.flagship_hasher("cpu").params
    exp = []
    for row in vals:
        acc = port.Scalar(row[0])
        for v in row[1:]:
            acc = Poseidon_hash_2(acc, port.Scalar(v), params, SboxType.Cube)
        exp.append(acc.v)
    assert FQ.to_ints(digest) == exp
    assert FQ.to_ints(checksum[None]) == [sum(exp) % L]
    jpts = [jaxpkg.RistrettoPoint.decompress(p.compress()) for p in pts]
    want = jmultiscalar_mul([jaxpkg.Scalar(k) for k in ks], jpts).compress()
    assert points_from_device(total)[0].compress() == want
    d1, c1 = pipeline.proving_step(witness, points, bits)
    assert torch.equal(d1, digest)
    assert points_from_device(c1) == points_from_device(total)

