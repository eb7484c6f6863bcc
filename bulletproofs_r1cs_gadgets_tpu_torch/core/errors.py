"""Typed errors mirroring ``bulletproofs::r1cs::R1CSError`` (SURVEY.md S5).

The reference surfaces ``R1CSError::MissingAssignment`` (e.g.
``reference/src/gadget_range_proof.rs:28``) and
``R1CSError::GadgetError { description }``
(``reference/src/gadget_poseidon.rs:136``).
"""

from __future__ import annotations


class R1CSError(Exception):
    """Base class for all proving-system errors."""


class MissingAssignment(R1CSError):
    """A variable assignment was required (prover side) but absent."""


class GadgetError(R1CSError):
    def __init__(self, description: str):
        super().__init__(description)
        self.description = description


class VerificationError(R1CSError):
    """The proof failed to verify."""


class FormatError(R1CSError):
    """Proof deserialization failed."""


class InvalidGeneratorsLength(R1CSError):
    """The BulletproofGens capacity is too small for the circuit."""
