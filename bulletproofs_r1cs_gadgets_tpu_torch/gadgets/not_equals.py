"""Not-equals gadget: committed v != public expected.

Reference: ``reference/src/gadget_not_equals.rs:11-26``: commit
diff = expected - v and diff^-1; constrain diff + v == expected, then
non-zeroness of diff.
"""

from __future__ import annotations

from ..core.scalar import Scalar
from ..core.transcript import Transcript
from ..core.prover import Prover
from ..core.verifier import Verifier
from .r1cs_utils import AllocatedScalar, constrain_lc_with_scalar
from .zero_nonzero import is_nonzero_gadget


def not_equals_gadget(
    cs,
    v: AllocatedScalar,
    diff_var: AllocatedScalar,
    diff_inv_var: AllocatedScalar,
    expected: int,
) -> None:
    # diff + v == expected
    constrain_lc_with_scalar(
        cs, diff_var.variable + v.variable, Scalar(expected)
    )
    # diff != 0
    is_nonzero_gadget(cs, diff_var, diff_inv_var)


def gen_proof_of_not_equals(
    value: int, expected: int, transcript_label: bytes, pc_gens, bp_gens, rng=None
):
    prover = Prover(pc_gens, Transcript(transcript_label), rng=rng)
    val = Scalar(value)
    com_v, var_v = prover.commit(val, Scalar.random())
    diff = Scalar(expected) - val
    com_d, var_d = prover.commit(diff, Scalar.random())
    diff_inv = diff.invert()
    com_di, var_di = prover.commit(diff_inv, Scalar.random())
    not_equals_gadget(
        prover,
        AllocatedScalar(var_v, val),
        AllocatedScalar(var_d, diff),
        AllocatedScalar(var_di, diff_inv),
        expected,
    )
    proof = prover.prove(bp_gens)
    return proof, [com_v, com_d, com_di]


def verify_proof_of_not_equals(
    expected: int, proof, commitments, transcript_label: bytes, pc_gens, bp_gens
) -> None:
    verifier = Verifier(Transcript(transcript_label))
    var_v = verifier.commit(commitments[0])
    var_d = verifier.commit(commitments[1])
    var_di = verifier.commit(commitments[2])
    not_equals_gadget(
        verifier,
        AllocatedScalar(var_v),
        AllocatedScalar(var_d),
        AllocatedScalar(var_di),
        expected,
    )
    verifier.verify(proof, pc_gens, bp_gens)
