"""Set membership via a chained product of committed differences.

Reference: ``reference/src/gadget_set_membership_1.rs:16-110``.
Commit diffs set[i] - v; constrain diff_i + v == set[i]; the running
product of all diffs must be 0 (n multipliers).
"""

from __future__ import annotations

from ..core.scalar import Scalar
from ..core.linear_combination import Variable
from ..core.transcript import Transcript
from ..core.prover import Prover
from ..core.verifier import Verifier
from .r1cs_utils import AllocatedScalar, constrain_lc_with_scalar


def set_membership_1_gadget(
    cs, v: AllocatedScalar, diff_vars: list[AllocatedScalar], set_values: list[int]
) -> None:
    product = Variable.One().lc()
    for i in range(len(set_values)):
        constrain_lc_with_scalar(
            cs, diff_vars[i].variable + v.variable, Scalar(set_values[i])
        )
        _, _, o = cs.multiply(product, diff_vars[i].variable.lc())
        product = o.lc()
    cs.constrain(product)


def gen_proof_of_set_membership_1(
    value: int,
    randomness: Scalar | None,
    set_values: list[int],
    transcript_label: bytes,
    pc_gens,
    bp_gens,
    rng=None,
):
    prover = Prover(pc_gens, Transcript(transcript_label), rng=rng)
    comms = []
    diff_vars = []
    val = Scalar(value)
    com_value, var_value = prover.commit(
        val, randomness if randomness is not None else Scalar.random()
    )
    alloc = AllocatedScalar(var_value, val)
    comms.append(com_value)
    for elem in set_values:
        diff = Scalar(elem) - val
        com_diff, var_diff = prover.commit(diff, Scalar.random())
        diff_vars.append(AllocatedScalar(var_diff, diff))
        comms.append(com_diff)
    set_membership_1_gadget(prover, alloc, diff_vars, set_values)
    proof = prover.prove(bp_gens)
    return proof, comms


def verify_proof_of_set_membership_1(
    set_values: list[int],
    proof,
    commitments,
    transcript_label: bytes,
    pc_gens,
    bp_gens,
) -> None:
    verifier = Verifier(Transcript(transcript_label))
    var_val = verifier.commit(commitments[0])
    alloc = AllocatedScalar(var_val)
    diff_vars = [
        AllocatedScalar(verifier.commit(commitments[i]))
        for i in range(1, len(set_values) + 1)
    ]
    set_membership_1_gadget(verifier, alloc, diff_vars, set_values)
    verifier.verify(proof, pc_gens, bp_gens)
