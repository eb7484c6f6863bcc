"""Pinocchio-style is-zero / is-nonzero gadgets.

Reference: ``reference/src/gadget_zero_nonzero.rs:21-66``.
  x * (1 - y) = 0 and x * inv = y  with (y, inv) = (0, 0) for x == 0
  and (1, x^-1) otherwise.  Two multipliers each.
"""

from __future__ import annotations

from ..core.scalar import Scalar
from ..core.linear_combination import Variable, LinearCombination
from .r1cs_utils import AllocatedScalar


def is_zero_gadget(cs, x: AllocatedScalar) -> None:
    """Enforce x == 0 (y = inv = 0 hard-coded as public constants)."""
    one = Variable.One()
    x_lc = x.variable.lc()
    one_minus_y_lc = LinearCombination([(one, Scalar.one())])  # 1 - 0
    y_lc = LinearCombination([(one, Scalar.zero())])
    inv_lc = LinearCombination([(one, Scalar.zero())])

    # x * (1 - y) = 0
    _, _, o1 = cs.multiply(x_lc, one_minus_y_lc)
    cs.constrain(o1.lc())

    # x * inv = y
    _, _, o2 = cs.multiply(x.variable.lc(), inv_lc)
    cs.constrain(o2 - y_lc)


def is_nonzero_gadget(cs, x: AllocatedScalar, x_inv: AllocatedScalar) -> None:
    """Enforce x != 0 given a committed inverse (also forces x*x_inv = 1)."""
    one = Variable.One()
    x_lc = x.variable.lc()
    y_lc = LinearCombination([(one, Scalar.one())])
    one_minus_y_lc = one.lc() - y_lc  # == 0, kept for structural parity

    # x * (1 - y) = 0
    _, _, o1 = cs.multiply(x_lc, one_minus_y_lc)
    cs.constrain(o1.lc())

    # x * x_inv = y (= 1)
    _, _, o2 = cs.multiply(x.variable.lc(), x_inv.variable.lc())
    cs.constrain(o2 - y_lc)
