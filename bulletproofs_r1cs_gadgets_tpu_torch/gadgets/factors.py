"""Factors gadget: knowledge of p, q with p*q = public r.

Reference: ``reference/src/factors.rs:12-21`` (1 multiplier,
1 linear constraint).
"""

from __future__ import annotations

from ..core.scalar import Scalar
from ..core.transcript import Transcript
from ..core.prover import Prover
from ..core.verifier import Verifier
from .r1cs_utils import AllocatedScalar, constrain_lc_with_scalar


def factors_gadget(cs, p: AllocatedScalar, q: AllocatedScalar, r: Scalar) -> None:
    _, _, o = cs.multiply(p.variable, q.variable)
    constrain_lc_with_scalar(cs, o, r)


def gen_proof_of_factors(
    p: Scalar, q: Scalar, transcript_label: bytes, pc_gens, bp_gens, rng=None
):
    """Prove knowledge of p, q for public r = p*q; returns (proof, comms, r)."""
    r = p * q
    prover = Prover(pc_gens, Transcript(transcript_label), rng=rng)
    com_p, var_p = prover.commit(p, Scalar.random())
    com_q, var_q = prover.commit(q, Scalar.random())
    factors_gadget(
        prover,
        AllocatedScalar(var_p, p),
        AllocatedScalar(var_q, q),
        r,
    )
    proof = prover.prove(bp_gens)
    return proof, [com_p, com_q], r


def verify_proof_of_factors(
    r: Scalar, proof, commitments, transcript_label: bytes, pc_gens, bp_gens
) -> None:
    verifier = Verifier(Transcript(transcript_label))
    var_p = verifier.commit(commitments[0])
    var_q = verifier.commit(commitments[1])
    factors_gadget(
        verifier, AllocatedScalar(var_p), AllocatedScalar(var_q), r
    )
    verifier.verify(proof, pc_gens, bp_gens)
