"""MiMC-2p/p Feistel hash - native and circuit duals.

Reference: ``reference/src/gadget_mimc.rs``: 322 rounds (:15), round
function ``xl, xr := xr + (xl + c_i)^3, xl`` - native :19-39, circuit
:55-79 (2 multipliers per round), preimage gadget :41-52.
"""

from __future__ import annotations

from ..core.scalar import Scalar
from ..core.linear_combination import LinearCombination, Variable, _coerce
from .r1cs_utils import AllocatedScalar, constrain_lc_with_scalar

from ..utils.config import DEFAULT_CONFIG

MIMC_ROUNDS = DEFAULT_CONFIG.mimc.rounds  # 322, gadget_mimc.rs:15


def mimc(xl: Scalar, xr: Scalar, constants: list[Scalar]) -> Scalar:
    """Native MiMC (``gadget_mimc.rs:19-39``)."""
    assert len(constants) == MIMC_ROUNDS
    for c in constants:
        tmp1 = xl + c
        tmp2 = tmp1 * tmp1 * tmp1 + xr
        xr = xl
        xl = tmp2
    return xl


def mimc_hash_2(cs, left, right, mimc_rounds: int, mimc_constants: list[Scalar]):
    """Circuit dual (``gadget_mimc.rs:55-79``)."""
    left_v = _coerce(left)
    right_v = _coerce(right)
    for j in range(mimc_rounds):
        const_lc = LinearCombination([(Variable.One(), mimc_constants[j])])
        left_plus_const = left_v + const_lc
        l, _, l_sqr = cs.multiply(left_plus_const, left_plus_const)
        _, _, l_cube = cs.multiply(l_sqr.lc(), l.lc())
        tmp = l_cube.lc() + right_v
        right_v = left_v
        left_v = tmp
    return left_v


def mimc_gadget(
    cs,
    left: AllocatedScalar,
    right: AllocatedScalar,
    mimc_rounds: int,
    mimc_constants: list[Scalar],
    image: Scalar,
) -> None:
    """Preimage gadget (``gadget_mimc.rs:41-52``)."""
    res = mimc_hash_2(
        cs, left.variable.lc(), right.variable.lc(), mimc_rounds, mimc_constants
    )
    constrain_lc_with_scalar(cs, res, image)
