"""Set membership via a committed one-hot bitmap (ethsnarks one_of_n style).

Reference: ``reference/src/gadget_set_membership.rs:16-171``.
Per set element: booleanity of the bitmap bit; sum(bits) == 1; and
sum(set[i] * bit[i]) == value via per-element product constraints.
3n multipliers for set size n.
"""

from __future__ import annotations

from ..core.scalar import Scalar
from ..core.linear_combination import Variable, LinearCombination
from ..core.transcript import Transcript
from ..core.prover import Prover
from ..core.verifier import Verifier
from .r1cs_utils import AllocatedQuantity, constrain_lc_with_scalar


def bit_gadget(cs, v: AllocatedQuantity) -> None:
    """Enforce v in {0, 1} (``gadget_set_membership.rs:16-38``)."""
    if v.assignment is not None:
        bit = v.assignment
        a, b, o = cs.allocate_multiplier((Scalar(1 - bit), Scalar(bit)))
    else:
        a, b, o = cs.allocate_multiplier(None)
    # b is (a reallocation of) v: b - v = 0
    cs.constrain(b + LinearCombination([(v.variable, -Scalar.one())]))
    # a * b = 0
    cs.constrain(o.lc())
    # a = 1 - b
    cs.constrain(a + (b - Scalar.one()))


def vector_sum_gadget(cs, vector: list[AllocatedQuantity], total: int) -> None:
    """Enforce sum(vector) == total (``gadget_set_membership.rs:41-54``)."""
    constraints = [(Variable.One(), -Scalar(total))]
    for item in vector:
        constraints.append((item.variable, Scalar.one()))
    cs.constrain(LinearCombination(constraints))


def vector_product_gadget(
    cs, items: list[int], vector: list[AllocatedQuantity], value: AllocatedQuantity
) -> None:
    """Enforce items[i]*vector[i] == vector[i]*value and
    sum_i items[i]*vector[i] == value (``gadget_set_membership.rs:58-86``)."""
    constraints = [(value.variable, -Scalar.one())]
    for i in range(len(items)):
        if vector[i].assignment is not None:
            bit_var, item_var, o1 = cs.allocate_multiplier(
                (Scalar(vector[i].assignment), Scalar(items[i]))
            )
        else:
            bit_var, item_var, o1 = cs.allocate_multiplier(None)
        constrain_lc_with_scalar(cs, item_var, Scalar(items[i]))
        _, _, o2 = cs.multiply(bit_var.lc(), value.variable.lc())
        cs.constrain(o1 - o2)
        constraints.append((o1, Scalar.one()))
    cs.constrain(LinearCombination(constraints))


def gen_proof_of_set_membership(
    value: int,
    randomness: Scalar | None,
    set_values: list[int],
    transcript_label: bytes,
    pc_gens,
    bp_gens,
    rng=None,
):
    bit_map = [1 if elem == value else 0 for elem in set_values]
    prover = Prover(pc_gens, Transcript(transcript_label), rng=rng)
    comms = []
    bit_vars = []
    for b in bit_map:
        com, var = prover.commit(Scalar(b), Scalar.random())
        q = AllocatedQuantity(var, b)
        bit_gadget(prover, q)
        comms.append(com)
        bit_vars.append(q)

    vector_sum_gadget(prover, bit_vars, 1)

    com_value, var_value = prover.commit(
        Scalar(value), randomness if randomness is not None else Scalar.random()
    )
    quantity_value = AllocatedQuantity(var_value, value)
    vector_product_gadget(prover, set_values, bit_vars, quantity_value)
    comms.append(com_value)

    proof = prover.prove(bp_gens)
    return proof, comms


def verify_proof_of_set_membership(
    set_values: list[int],
    proof,
    commitments,
    transcript_label: bytes,
    pc_gens,
    bp_gens,
) -> None:
    set_length = len(set_values)
    verifier = Verifier(Transcript(transcript_label))
    bit_vars = []
    for i in range(set_length):
        var = verifier.commit(commitments[i])
        q = AllocatedQuantity(var)
        bit_gadget(verifier, q)
        bit_vars.append(q)
    vector_sum_gadget(verifier, bit_vars, 1)
    var_val = verifier.commit(commitments[set_length])
    vector_product_gadget(
        verifier, set_values, bit_vars, AllocatedQuantity(var_val)
    )
    verifier.verify(proof, pc_gens, bp_gens)
