"""The device-oracle path of the port against the JAX package, on the CPU.

``LimbField`` (``FQ`` / ``FP``) against the JAX package's ``FQ`` / ``FP``
on the same ints (converted by ``carry.field_words``); ``DevicePoseidon``
with both S-boxes against the JAX package's host ``Poseidon_permutation``
(parameters carried over by ``carry``); ``proving_step`` against the host
oracles of ``tests/test_parallel.py``'s sharded-step test (the Poseidon
2:1 chain with the cube S-box, ``multiscalar_mul``); the curve API and
``MsmEngine`` / ``msm_device`` against the host group law, Elligator and
MSM; and a ``DeviceBackend("cpu", min_device_n=1)`` proof byte-identical to
the JAX package's host-path proof with the same rng, verified through
``DeviceBackend`` and rejected when tampered.  On the CPU every kernel
wrapper runs its plain version; the wrappers' calls are counted.
Tolerance: equal values mod the modulus, equal group elements, equal bytes.
"""

import hashlib

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu.core import scvec as jscvec
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import (
    RistrettoPoint as JPoint,
    multiscalar_mul as jmsm,
)
from bulletproofs_r1cs_gadgets_tpu.core.scalar import Scalar as JScalar
from bulletproofs_r1cs_gadgets_tpu.gadgets import poseidon as jposeidon
from bulletproofs_r1cs_gadgets_tpu.ops.field import FP as JFP, FQ as JFQ
from bulletproofs_r1cs_gadgets_tpu_torch import R1CSProof, VerificationError
from bulletproofs_r1cs_gadgets_tpu_torch import carry
from bulletproofs_r1cs_gadgets_tpu_torch.core import scvec
from bulletproofs_r1cs_gadgets_tpu_torch.core.ristretto import (
    RistrettoPoint as TPoint,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import curve as C
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F
from bulletproofs_r1cs_gadgets_tpu_torch.ops import msm as M
from bulletproofs_r1cs_gadgets_tpu_torch.ops.backend import DeviceBackend
from bulletproofs_r1cs_gadgets_tpu_torch.ops.field import FP, FQ
from bulletproofs_r1cs_gadgets_tpu_torch.ops.poseidon import DevicePoseidon
from bulletproofs_r1cs_gadgets_tpu_torch.parallel import pipeline
from bulletproofs_r1cs_gadgets_tpu_torch.utils.constants import L, P
from test_torch_backend import CIRCUITS, _host_proof, count_calls
from test_torch_host import poseidon_arrays

torch.set_num_threads(1)
rng = np.random.RandomState(20261018)
ORACLE_KERNELS = ("padd", "pdbl", "smul_lanes", "msm_block_totals",
                  "msm_chunk_acc", "fold_grid", "mul_fp", "mul_fq",
                  "poseidon_permute", "poseidon_chain")


def _ints(n: int, m: int) -> list[int]:
    return [int.from_bytes(rng.bytes(32), "little") % m for _ in range(n)]


def _tp(points) -> list[TPoint]:
    return [TPoint(p.X, p.Y, p.Z, p.T) for p in points]


def _host_points(n: int) -> list[JPoint]:
    B = JPoint.basepoint()
    return [B.scalar_mul(JScalar(k % L + 1)) for k in _ints(n, L)]


@pytest.mark.parametrize("name", ["fq", "fp"])
def test_limb_field_matches_jax(name):
    port, jax_f = (FQ, JFQ) if name == "fq" else (FP, JFP)
    m = port.modulus
    xs = [0, 1, m - 1, 2, m - 2] + _ints(11, m)
    ys = [m - 1, 0, m - 1, m - 1, 3] + _ints(11, m)
    ja, jb = jax_f.to_device(xs), jax_f.to_device(ys)
    # the same state: the JAX package's limbs, carried over
    a = carry.field_words(np.asarray(ja), m)
    b = carry.field_words(np.asarray(jb), m)
    assert torch.equal(a, port.to_device(xs, "cpu"))

    def same(got, want):
        assert torch.equal(got, carry.field_words(np.asarray(want), m))

    same(port.add(a, b), jax_f.add(ja, jb))
    same(port.sub(a, b), jax_f.sub(ja, jb))
    same(port.neg(a), jax_f.neg(ja))
    same(port.mul(a, b), jax_f.mul(ja, jb))
    same(port.square(a), jax_f.square(ja))
    same(port.scale_small(a, -7), jax_f.scale_small(ja, -7))
    assert port.to_ints(port.pow_const(a, 0x1234567)) == [
        pow(x, 0x1234567, m) for x in xs]
    same(port.pow_const(a, 0), jax_f.pow_const(ja, 0))
    inv = port.inv(a[:4])
    same(inv, jax_f.inv(ja[:4]))
    assert torch.equal(port.batch_inv(a[:4]), inv)
    cond = torch.tensor([i % 3 == 0 for i in range(len(xs))])
    same(port.select(cond, a, b), jax_f.select(np.asarray(cond), ja, jb))
    same(port.canonicalize(a), jax_f.canonicalize(ja))
    assert torch.equal(port.to_bits(a), torch.from_numpy(
        np.asarray(jax_f.to_bits(ja)).astype(np.int32)))
    assert torch.equal(port.eq(a, b), torch.from_numpy(np.array(jax_f.eq(ja, jb))))
    assert port.to_ints(a) == jax_f.to_ints(ja)
    # any words below 2^256 reduce to the canonical residue
    big = torch.from_numpy(F.ints_to_words([(1 << 256) - 1, m, m + 5]).copy())
    assert port.to_ints(port.canonicalize(big)) == [
        ((1 << 256) - 1) % m, 0, 5]
    assert F.words_to_ints(port.canonicalize(big).numpy())[1:] == [0, 5]


@pytest.mark.parametrize("sbox", ["cube", "inverse"])
def test_device_poseidon_matches_jax_permutation(sbox):
    jp = jposeidon.PoseidonParams(6, 4, 4, 8)
    params = carry.poseidon_params_from_arrays(**poseidon_arrays(jp))
    jsbox = jposeidon.SboxType.Cube if sbox == "cube" else jposeidon.SboxType.Inverse
    rows = [_ints(6, L) for _ in range(2)]
    rows[1][0] = 0  # inverse S-box: inv(0) == 0
    want = [[s.v for s in jposeidon.Poseidon_permutation(
        [JScalar(v) for v in r], jp, jsbox)] for r in rows]
    h = DevicePoseidon(params, sbox, device="cpu")
    state = FQ.to_device([v for r in rows for v in r], "cpu").reshape(2, 6, 8)
    assert FQ.to_ints(h.permute(state)) == [v for r in want for v in r]


def test_proving_step_matches_host_oracles(monkeypatch):
    """B = 2 proofs, W = 3, N = 8 points, 16-bit scalars
    (tests/test_parallel.py:186's oracles)."""
    B, W, N, NBITS = 2, 3, 8, 16
    vals = [[3 * i + j + 1 for j in range(W)] for i in range(B)]
    witness = carry.field_words(
        np.asarray(JFQ.to_device([v for r in vals for v in r])), L
    ).reshape(B, W, 8)
    base = JPoint.basepoint()
    pts = [base.scalar_mul(JScalar(i + 1)) for i in range(N)]
    ks = [int(rng.randint(1, 1 << 15)) for _ in range(N)]
    bits = torch.tensor([[(k >> b) & 1 for b in range(NBITS)] for k in ks],
                        dtype=torch.int32)
    calls = count_calls(monkeypatch, ORACLE_KERNELS)
    digest, commitment = pipeline.proving_step(
        witness, C.points_to_device(_tp(pts), "cpu"), bits
    )
    jp = jposeidon.PoseidonParams(6, 4, 4, 140)
    exp = []
    for row in vals:
        acc = JScalar(row[0])
        for v in row[1:]:
            acc = jposeidon.Poseidon_hash_2(acc, JScalar(v), jp,
                                            jposeidon.SboxType.Cube)
        exp.append(acc.v)
    assert FQ.to_ints(digest) == exp
    assert C.points_from_device(commitment) == _tp(
        [jmsm([JScalar(k) for k in ks], pts)])
    assert calls["smul_lanes"] == 1 and calls["padd"] == 3  # log2(8) rounds
    assert calls["mul_fq"] == 0  # the whole path in one chain launch
    assert calls["poseidon_chain"] == 1 and calls["poseidon_permute"] == 0


def test_curve_api_matches_host():
    ps, qs = _host_points(6), _host_points(6)
    tp, tq = C.points_to_device(_tp(ps), "cpu"), C.points_to_device(_tp(qs), "cpu")
    assert C.points_from_device(C.point_add(tp, tq)) == _tp(
        [p + q for p, q in zip(ps, qs)])
    assert C.points_from_device(C.point_double(tp)) == _tp([p.double() for p in ps])
    assert C.points_from_device(C.point_neg(tp)) == _tp([-p for p in ps])
    cond = torch.tensor([True, False] * 3)
    assert C.points_from_device(C.point_select(cond, tp, tq)) == _tp(
        [p if i % 2 == 0 else q for i, (p, q) in enumerate(zip(ps, qs))])
    k = 0xB00B5 * L // (1 << 40)
    assert C.points_from_device(C.scalar_mul_shared(tp, k)) == _tp(
        [p.scalar_mul(JScalar(k)) for p in ps])
    assert all(p.is_identity() for p in
               C.points_from_device(C.scalar_mul_shared(tp, 0)))
    total = ps[0]
    for p in ps[1:5]:
        total = total + p
    assert C.points_from_device(C.tree_reduce(tp[:5])) == _tp([total])
    assert C.identity_points((2, 3), "cpu").shape == (2, 3, 4, 8)
    # the batched Elligator, against the host map of each seed
    seeds = [hashlib.sha512(bytes([i])).digest() for i in range(4)]
    got = C.from_uniform_bytes_batch(seeds, device="cpu")
    assert got == _tp([JPoint.from_uniform_bytes(s) for s in seeds])
    # sqrt_ratio's flag: u / v square or not (1 / 2 is not, 4 / 1 is)
    u = FP.to_device([1, 4, 0], "cpu")
    v = FP.to_device([2, 1, 5], "cpu")
    ok, r = C.sqrt_ratio(u, v)
    assert ok.tolist() == [False, True, True]
    assert FP.to_ints(r)[1:] == [2, 0]


def test_msm_engine_and_msm_device_match_host(monkeypatch):
    n = 40
    ps = _host_points(n)
    ks = _ints(n, L)
    ks[3] = 0
    want = jmsm([JScalar(k) for k in ks], ps)
    rows = scvec.from_ints(ks)
    calls = count_calls(monkeypatch, ORACLE_KERNELS)
    eng = M.MsmEngine("cpu")
    tps = _tp(ps)
    assert eng.msm(rows, tps) == _tp([want])[0]
    assert eng.device_points(tps) is eng.device_points(tps)  # cached
    monkeypatch.setattr(M, "CHUNK", 16)  # three chained launch pairs
    dev = C.points_to_device(tps, "cpu")
    acc = C.points_to_device(_tp([ps[0]]), "cpu")
    assert C.points_from_device(M.msm_device(ks, dev, acc)) == _tp([want + ps[0]])
    assert calls["msm_block_totals"] == 1 and calls["msm_chunk_acc"] == 3


def test_device_backend_proof_matches_jax_host(monkeypatch):
    """The bound-check circuit (tests/test_torch_backend.py, padded to 128)
    through DeviceBackend("cpu", min_device_n=1): every MSM and every fold
    on the device path, bytes equal to the JAX package's host engine."""
    circ = CIRCUITS["bound"]
    comms, ref = _host_proof("bound")
    backend = DeviceBackend("cpu", min_device_n=1)
    calls = count_calls(monkeypatch, ORACLE_KERNELS)
    comms_t, got = circ.prove(backend)
    assert comms_t == comms
    assert got.to_bytes() == ref.to_bytes()
    rounds = len(got.ipp_proof.L_vec)
    # phase 1: 3 MSMs; IPP: L and R per round, G and H folded per round
    assert calls["msm_chunk_acc"] == 3 + 2 * rounds
    assert calls["fold_grid"] == 2 * rounds
    circ.verify(comms, got, backend)
    assert calls["msm_chunk_acc"] == 4 + 2 * rounds
    raw = bytearray(got.to_bytes())
    raw[len(raw) - 64] ^= 1
    with pytest.raises(VerificationError):
        circ.verify(comms, R1CSProof.from_bytes(bytes(raw)), backend)


def test_carry_field_and_point_stacks():
    xs = [0, 1, L - 1, (1 << 255) + 7] + _ints(4, 1 << 255)
    for m, jf in ((L, JFQ), (P, JFP)):
        limbs = np.asarray(jf.to_device(xs))
        assert F.words_to_ints(carry.field_words(limbs, m).numpy()) == [
            x % m for x in xs]
        stack = limbs.T.reshape(23, 8, 1)
        assert torch.equal(carry.stacked_field(stack, m),
                           carry.field_words(limbs, m))
    with pytest.raises(ValueError):
        carry.field_words(np.zeros((2, 23), np.int32), 7)
    ps = _host_points(8)
    from bulletproofs_r1cs_gadgets_tpu.ops.curve import points_to_device
    from bulletproofs_r1cs_gadgets_tpu.ops.pallas_curve import (
        points_to_rows, words_matrix, words_to_rows,
    )
    rows = np.asarray(points_to_rows(points_to_device(ps)))  # (92, 8, 1)
    assert F.to_points(carry.stacked_points(rows)) == _tp(ps)
    w = words_matrix(xs)
    assert np.array_equal(carry.stacked_words(np.asarray(words_to_rows(w))).numpy(), w)
    assert np.array_equal(jscvec.words_u32(jscvec.from_ints([x % L for x in xs]))
                          .view(np.int32), scvec.words_u32(
                              scvec.from_ints([x % L for x in xs])).view(np.int32))
