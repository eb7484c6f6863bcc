"""Shared gadget utilities (reference: ``reference/src/r1cs_utils.rs``).

* :class:`AllocatedQuantity` / :class:`AllocatedScalar` - a circuit variable
  together with its (prover-side) assignment (``r1cs_utils.rs:7-17``).
* :func:`positive_no_gadget` - n-bit binary decomposition range check
  (``r1cs_utils.rs:20-48``): per bit one multiplier with constraints
  ``o = 0`` (a*b = 0), ``a + b - 1 = 0`` (booleanity), then
  ``sum b_i 2^i = v``.
* :func:`constrain_lc_with_scalar` - LC == public scalar
  (``r1cs_utils.rs:51-53``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.scalar import Scalar
from ..core.linear_combination import Variable, LinearCombination, _coerce


@dataclass
class AllocatedQuantity:
    """A u64-valued allocated variable (assignment is a Python int or None)."""

    variable: Variable
    assignment: int | None = None


@dataclass
class AllocatedScalar:
    """A field-valued allocated variable."""

    variable: Variable
    assignment: Scalar | None = None


def positive_no_gadget(cs, v: AllocatedQuantity, bit_size: int) -> None:
    """Enforce that v is in [0, 2^bit_size)."""
    constraint_v = [(v.variable, -Scalar.one())]
    exp_2 = Scalar.one()
    for i in range(bit_size):
        if v.assignment is not None:
            bit = (v.assignment >> i) & 1
            a, b, o = cs.allocate_multiplier((Scalar(1 - bit), Scalar(bit)))
        else:
            a, b, o = cs.allocate_multiplier(None)
        # a * b = 0, so one of (a, b) is zero
        cs.constrain(o.lc())
        # a = 1 - b, so both are bits
        cs.constrain(a + (b - Scalar.one()))
        constraint_v.append((b, exp_2))
        exp_2 = exp_2 + exp_2
    # sum(b_i * 2^i) - v = 0
    cs.constrain(LinearCombination(constraint_v))


def constrain_lc_with_scalar(cs, lc, scalar: Scalar) -> None:
    """Constrain a linear combination to equal a public scalar."""
    cs.constrain(_coerce(lc) - scalar)
