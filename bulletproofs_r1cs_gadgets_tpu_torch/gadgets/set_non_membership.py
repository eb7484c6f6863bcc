"""Set NON-membership: committed v differs from every set element.

Reference: ``reference/src/gadget_set_non_membership.rs:17-125``.
Per element: commit diff = set[i] - v and its inverse; constrain
diff + v == set[i] and diff != 0 (2n multipliers).
"""

from __future__ import annotations

from ..core.scalar import Scalar
from ..core.transcript import Transcript
from ..core.prover import Prover
from ..core.verifier import Verifier
from .r1cs_utils import AllocatedScalar, constrain_lc_with_scalar
from .zero_nonzero import is_nonzero_gadget


def set_non_membership_gadget(
    cs,
    v: AllocatedScalar,
    diff_vars: list[AllocatedScalar],
    diff_inv_vars: list[AllocatedScalar],
    set_values: list[int],
) -> None:
    for i in range(len(set_values)):
        constrain_lc_with_scalar(
            cs, diff_vars[i].variable + v.variable, Scalar(set_values[i])
        )
        is_nonzero_gadget(cs, diff_vars[i], diff_inv_vars[i])


def gen_proof_of_set_non_membership(
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
    diff_inv_vars = []
    val = Scalar(value)
    com_value, var_value = prover.commit(
        val, randomness if randomness is not None else Scalar.random()
    )
    alloc = AllocatedScalar(var_value, val)
    comms.append(com_value)
    for elem in set_values:
        diff = Scalar(elem) - val
        diff_inv = diff.invert()
        com_diff, var_diff = prover.commit(diff, Scalar.random())
        diff_vars.append(AllocatedScalar(var_diff, diff))
        comms.append(com_diff)
        com_diff_inv, var_diff_inv = prover.commit(diff_inv, Scalar.random())
        diff_inv_vars.append(AllocatedScalar(var_diff_inv, diff_inv))
        comms.append(com_diff_inv)
    set_non_membership_gadget(prover, alloc, diff_vars, diff_inv_vars, set_values)
    proof = prover.prove(bp_gens)
    return proof, comms


def verify_proof_of_set_non_membership(
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
    diff_vars = []
    diff_inv_vars = []
    for i in range(1, len(set_values) + 1):
        diff_vars.append(AllocatedScalar(verifier.commit(commitments[2 * i - 1])))
        diff_inv_vars.append(AllocatedScalar(verifier.commit(commitments[2 * i])))
    set_non_membership_gadget(verifier, alloc, diff_vars, diff_inv_vars, set_values)
    verifier.verify(proof, pc_gens, bp_gens)
