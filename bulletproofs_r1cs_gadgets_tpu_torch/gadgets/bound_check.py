"""Bound-check gadget: min <= v <= max for committed v.

Reference: ``reference/src/gadget_bound_check.rs:18-121``.
Commit a = v - min and b = max - v; constrain v - min - a = 0,
max - v - b = 0, a + b = max - min, and both a, b in [0, 2^bit_size)
via :func:`positive_no_gadget`.
"""

from __future__ import annotations

from ..core.scalar import Scalar
from ..core.transcript import Transcript
from ..core.prover import Prover
from ..core.verifier import Verifier
from .r1cs_utils import (
    AllocatedQuantity,
    positive_no_gadget,
    constrain_lc_with_scalar,
)


def bound_check_gadget(
    cs,
    v: AllocatedQuantity,
    a: AllocatedQuantity,
    b: AllocatedQuantity,
    maximum: int,
    minimum: int,
    bit_size: int,
) -> None:
    # v - min - a = 0
    cs.constrain(v.variable - Scalar(minimum) - a.variable)
    # max - v - b = 0
    cs.constrain(Scalar(maximum) - v.variable - b.variable)
    # a + b = max - min
    constrain_lc_with_scalar(
        cs, a.variable + b.variable, Scalar(maximum - minimum)
    )
    positive_no_gadget(cs, a, bit_size)
    positive_no_gadget(cs, b, bit_size)


def gen_proof_of_bounded_num(
    val: int,
    randomness: Scalar | None,
    lower: int,
    upper: int,
    max_bits_in_val: int,
    transcript_label: bytes,
    pc_gens,
    bp_gens,
    rng=None,
    backend=None,
):
    a = val - lower
    b = upper - val
    prover = Prover(pc_gens, Transcript(transcript_label), rng=rng)
    comms = []

    com_v, var_v = prover.commit(
        Scalar(val), randomness if randomness is not None else Scalar.random()
    )
    comms.append(com_v)
    com_a, var_a = prover.commit(Scalar(a), Scalar.random())
    comms.append(com_a)
    com_b, var_b = prover.commit(Scalar(b), Scalar.random())
    comms.append(com_b)

    bound_check_gadget(
        prover,
        AllocatedQuantity(var_v, val),
        AllocatedQuantity(var_a, a),
        AllocatedQuantity(var_b, b),
        upper,
        lower,
        max_bits_in_val,
    )
    proof = prover.prove(bp_gens, backend=backend)
    return proof, comms


def verify_proof_of_bounded_num(
    lower: int,
    upper: int,
    max_bits_in_val: int,
    proof,
    commitments,
    transcript_label: bytes,
    pc_gens,
    bp_gens,
    backend=None,
) -> None:
    verifier = Verifier(Transcript(transcript_label))
    var_v = verifier.commit(commitments[0])
    var_a = verifier.commit(commitments[1])
    var_b = verifier.commit(commitments[2])
    bound_check_gadget(
        verifier,
        AllocatedQuantity(var_v),
        AllocatedQuantity(var_a),
        AllocatedQuantity(var_b),
        upper,
        lower,
        max_bits_in_val,
    )
    verifier.verify(proof, pc_gens, bp_gens, backend=backend)


def count_bits(number: int) -> int:
    """Bits needed for number (``gadget_bound_check.rs:118-121``)."""
    return number.bit_length()
