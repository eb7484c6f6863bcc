"""Legacy range-proof variant (no commitment to v itself).

Reference: ``reference/src/gadget_range_proof.rs`` - live code there is
only ``count_bits`` plus a test exercising two ``positive_no_gadget`` calls
with the linking constraint ``a + b = max - min`` (``:127-202``); the older
gadget API is commented out.  We expose the same helper flow.
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
from .bound_check import count_bits  # same helper, single definition


def gen_range_proof(
    v: int, minimum: int, maximum: int, transcript_label: bytes, pc_gens, bp_gens,
    rng=None,
):
    """Prove min <= v <= max without committing v (only a = v-min, b = max-v)."""
    n = count_bits(maximum)
    a = v - minimum
    b = maximum - v
    prover = Prover(pc_gens, Transcript(transcript_label), rng=rng)
    comms = []
    com_a, var_a = prover.commit(Scalar(a), Scalar.random())
    positive_no_gadget(prover, AllocatedQuantity(var_a, a), n)
    comms.append(com_a)
    com_b, var_b = prover.commit(Scalar(b), Scalar.random())
    positive_no_gadget(prover, AllocatedQuantity(var_b, b), n)
    comms.append(com_b)
    constrain_lc_with_scalar(
        prover, var_a + var_b, Scalar(maximum - minimum)
    )
    proof = prover.prove(bp_gens)
    return proof, comms


def verify_range_proof(
    minimum: int, maximum: int, proof, commitments, transcript_label: bytes,
    pc_gens, bp_gens,
) -> None:
    n = count_bits(maximum)
    verifier = Verifier(Transcript(transcript_label))
    var_a = verifier.commit(commitments[0])
    positive_no_gadget(verifier, AllocatedQuantity(var_a), n)
    var_b = verifier.commit(commitments[1])
    positive_no_gadget(verifier, AllocatedQuantity(var_b), n)
    constrain_lc_with_scalar(
        verifier, var_a + var_b, Scalar(maximum - minimum)
    )
    verifier.verify(proof, pc_gens, bp_gens)
