"""The port's own host layers against the JAX package's.

The port keeps verbatim copies of the JAX package's jax-free layers
(``core/``, ``utils/``, ``gadgets/``, ``models/``, ``parallel/batch.py``,
``native/``).  Here each copy is held against its original on the same
inputs: generator arrays and Pedersen bases, a Poseidon permutation,
transcript challenges, the state carried across by ``carry.py``, and a
depth-4 VSMT-2 host proof (``backend=None``), byte-identical between the
two packages and equal to the committed golden digest of the JAX
package's proof (``golden/vsmt2_depth4.json``, which ``chip_smoke.py``
holds the card's proof to).  Each package's verifier accepts the other's
proof, parsed from bytes.  Tolerance: exact (equal arrays, points and
bytes).
"""

import json
import types

import numpy as np
import pytest

import bulletproofs_r1cs_gadgets_tpu_torch as bp
import chip_smoke as cs
from bulletproofs_r1cs_gadgets_tpu.core import pedersen as jpedersen
from bulletproofs_r1cs_gadgets_tpu.core import scvec as jscvec
from bulletproofs_r1cs_gadgets_tpu.core.errors import (
    VerificationError as JVerificationError,
)
from bulletproofs_r1cs_gadgets_tpu.core.proof import R1CSProof as JR1CSProof
from bulletproofs_r1cs_gadgets_tpu.core.prover import Prover as JProver
from bulletproofs_r1cs_gadgets_tpu.core.scalar import Scalar as JScalar
from bulletproofs_r1cs_gadgets_tpu.core.transcript import (
    Transcript as JTranscript,
)
from bulletproofs_r1cs_gadgets_tpu.core.verifier import Verifier as JVerifier
from bulletproofs_r1cs_gadgets_tpu.gadgets import poseidon as jposeidon
from bulletproofs_r1cs_gadgets_tpu.models.compiled import (
    CompiledVSMT2 as JCompiledVSMT2,
)
from bulletproofs_r1cs_gadgets_tpu.models.vsmt2 import (
    VanillaSparseMerkleTree as JTree,
)
from bulletproofs_r1cs_gadgets_tpu.models.vsmt2 import (
    leaf_index_bit_scalars as jleaf_bits,
)
from bulletproofs_r1cs_gadgets_tpu_torch import carry
from bulletproofs_r1cs_gadgets_tpu_torch.gadgets import poseidon as tposeidon

# chip_smoke's helpers take a package namespace: the port's module is one,
# and this is the JAX package's
JAX = types.SimpleNamespace(
    Scalar=JScalar, PoseidonParams=jposeidon.PoseidonParams,
    VanillaSparseMerkleTree=JTree, leaf_index_bit_scalars=jleaf_bits,
    CompiledVSMT2=JCompiledVSMT2, Prover=JProver, Verifier=JVerifier,
    PedersenGens=jpedersen.PedersenGens, Transcript=JTranscript,
    BulletproofGens=jpedersen.BulletproofGens, R1CSProof=JR1CSProof,
    VerificationError=JVerificationError,
)
GOLDEN_N = 1 << 12  # chip_smoke's gens_small


def poseidon_arrays(params) -> dict:
    """The arrays of a JAX ``PoseidonParams``: the keyword arguments of
    ``carry.poseidon_params_from_arrays``."""
    return dict(
        width=params.width,
        full_rounds_beginning=params.full_rounds_beginning,
        full_rounds_end=params.full_rounds_end,
        partial_rounds=params.partial_rounds,
        round_keys=jscvec.from_ints([s.v for s in params.round_keys]),
        mds=jscvec.from_ints([s.v for row in params.MDS_matrix for s in row]),
    )


def test_generators_and_pedersen_bases_match():
    n = 64
    jg, tg = jpedersen.BulletproofGens(n), bp.BulletproofGens(n)
    assert np.array_equal(jg.G_raw(n), tg.G_raw(n))
    assert np.array_equal(jg.H_raw(n), tg.H_raw(n))
    assert [p.compress() for p in jg.G(8)] == [p.compress() for p in tg.G(8)]
    jpc, tpc = jpedersen.PedersenGens.default(), bp.PedersenGens.default()
    assert jpc.B.compress() == tpc.B.compress()
    assert jpc.B_blinding.compress() == tpc.B_blinding.compress()
    assert (jpc.commit(JScalar(5), JScalar(7)).compress()
            == tpc.commit(bp.Scalar(5), bp.Scalar(7)).compress())


def test_poseidon_permutation_matches():
    rng = np.random.RandomState(3)
    jp = jposeidon.PoseidonParams(6, 4, 4, 140)
    tp = bp.PoseidonParams(6, 4, 4, 140)
    for _ in range(3):
        xs = [int.from_bytes(rng.bytes(32), "little") % bp.L for _ in range(6)]
        for sbox in ("Cube", "Inverse"):
            j = jposeidon.Poseidon_permutation(
                [JScalar(x) for x in xs], jp, getattr(jposeidon.SboxType, sbox)
            )
            t = tposeidon.Poseidon_permutation(
                [bp.Scalar(x) for x in xs], tp, getattr(tposeidon.SboxType, sbox)
            )
            assert [s.v for s in j] == [s.v for s in t]


def test_transcript_challenges_match():
    jt, tt = JTranscript(b"port-host"), bp.Transcript(b"port-host")
    for i in range(4):
        msg = bytes(range(i, i + 40))
        jt.append_message(b"m", msg)
        tt.append_message(b"m", msg)
        jt.append_u64(b"i", i)
        tt.append_u64(b"i", i)
        assert jt.challenge_scalar(b"c").v == tt.challenge_scalar(b"c").v
        jt.innerproduct_domain_sep(64 + i)
        tt.innerproduct_domain_sep(64 + i)
    assert jt.challenge_bytes(b"b", 48) == tt.challenge_bytes(b"b", 48)


def test_carry_round_trips_jax_state():
    n = 64
    jg = jpedersen.BulletproofGens(n)
    got = carry.bulletproof_gens_from_arrays(jg.G_raw(n), jg.H_raw(n))
    own = bp.BulletproofGens(n)
    assert got.gens_capacity == n and got.party_capacity == 1
    assert np.array_equal(got.G_raw(n), own.G_raw(n))
    assert np.array_equal(got.H_raw(n), own.H_raw(n))
    assert [p.compress() for p in got.H(5)] == [p.compress() for p in own.H(5)]
    with pytest.raises(ValueError):
        carry.bulletproof_gens_from_arrays(jg.G_raw(n), jg.H_raw(n - 1))

    jp = jposeidon.PoseidonParams(6, 4, 4, 140)
    arrays = poseidon_arrays(jp)
    assert arrays["round_keys"].shape == (148 * 6, 4)
    assert arrays["mds"].shape == (36, 4)
    got = carry.poseidon_params_from_arrays(**arrays)
    own = bp.PoseidonParams(6, 4, 4, 140)
    assert [s.v for s in got.round_keys] == [s.v for s in own.round_keys]
    assert ([[s.v for s in row] for row in got.MDS_matrix]
            == [[s.v for s in row] for row in own.MDS_matrix])
    xs = [bp.Scalar(i + 1) for i in range(6)]
    assert ([s.v for s in tposeidon.Poseidon_permutation(
                xs, got, tposeidon.SboxType.Inverse)]
            == [s.v for s in tposeidon.Poseidon_permutation(
                xs, own, tposeidon.SboxType.Inverse)])


def _golden_proof(pkg, gens, params=None):
    """chip_smoke's depth-4 VSMT-2 proof (leaf 7, rng seed 11) through
    `pkg`'s host engine."""
    if params is None:
        params = pkg.PoseidonParams(6, 4, 4, 140)
    tree = pkg.VanillaSparseMerkleTree(params, depth=cs.SMALL_DEPTH)
    for i in range(1, 11):
        tree.update(pkg.Scalar(i), pkg.Scalar(i))
    comp, tape, comms, prover = cs.synthesize(
        pkg, params, tree, cs.SMALL_DEPTH, 11
    )
    return comp, tape, comms, prover.prove(gens, backend=None)


@pytest.fixture(scope="module")
def jax_proof():
    return _golden_proof(JAX, jpedersen.BulletproofGens(GOLDEN_N))


@pytest.fixture(scope="module")
def port_proof():
    """The port's proof on state carried from the JAX package (its
    generator and Poseidon arrays): the two engines see the same inputs."""
    jg = jpedersen.BulletproofGens(GOLDEN_N)
    gens = carry.bulletproof_gens_from_arrays(
        jg.G_raw(GOLDEN_N), jg.H_raw(GOLDEN_N)
    )
    params = carry.poseidon_params_from_arrays(
        **poseidon_arrays(jposeidon.PoseidonParams(6, 4, 4, 140))
    )
    return _golden_proof(bp, gens, params)


def _golden():
    with open(cs.GOLDEN) as f:
        return json.load(f)


def test_golden_digest_of_the_jax_package(jax_proof):
    _, _, comms, proof = jax_proof
    got = cs.proof_digest(comms, proof)
    want = _golden()
    assert got == {k: want[k] for k in got}


def test_port_host_proof_matches_the_jax_package(jax_proof, port_proof):
    _, _, jcomms, jproof = jax_proof
    _, _, tcomms, tproof = port_proof
    assert tcomms == jcomms
    assert tproof.to_bytes() == jproof.to_bytes()
    got = cs.proof_digest(tcomms, tproof)
    want = _golden()
    assert got == {k: want[k] for k in got}


@pytest.mark.parametrize("prover_pkg", ["jax", "port"])
def test_verifiers_accept_each_others_proofs(prover_pkg, jax_proof,
                                             port_proof):
    """The other package's verifier accepts the proof parsed from bytes,
    and rejects it with one flipped byte."""
    made = jax_proof if prover_pkg == "jax" else port_proof
    checker = bp if prover_pkg == "jax" else JAX
    _, _, comms, proof = made
    params = checker.PoseidonParams(6, 4, 4, 140)
    comp = checker.CompiledVSMT2(params, cs.SMALL_DEPTH,
                                 constrain_index_bits=False)
    tree = checker.VanillaSparseMerkleTree(params, depth=cs.SMALL_DEPTH)
    for i in range(1, 11):
        tree.update(checker.Scalar(i), checker.Scalar(i))
    tape = comp.tape(tree.root)
    gens = checker.BulletproofGens(GOLDEN_N)
    raw = proof.to_bytes()
    cs.verify(checker, comp, tape, comms,
              checker.R1CSProof.from_bytes(raw), gens, None)
    bad = bytearray(raw)
    bad[len(bad) - 64] ^= 1
    with pytest.raises(checker.VerificationError):
        cs.verify(checker, comp, tape, comms,
                  checker.R1CSProof.from_bytes(bytes(bad)), gens, None)
