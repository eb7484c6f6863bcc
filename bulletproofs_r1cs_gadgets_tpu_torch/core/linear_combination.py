"""R1CS variables and linear combinations.

Equivalent of ``bulletproofs::r1cs::{Variable, LinearCombination}``
(SURVEY.md S2b N5).  The reference gadgets build LCs with ``+ - *``,
``Variable::One()`` (``reference/src/gadget_set_membership.rs:46``),
``From`` conversions and ``iter().collect()``
(``reference/src/r1cs_utils.rs:45``); the fork adds ``get_terms``
(``reference/src/gadget_poseidon.rs:102``).

Python operators accept Variable / LinearCombination / Scalar / int on either
side so gadget code reads close to the Rust original.
"""

from __future__ import annotations

from enum import IntEnum
from .scalar import Scalar
from ..utils.constants import L as _L


class VarKind(IntEnum):
    COMMITTED = 0
    MULT_LEFT = 1
    MULT_RIGHT = 2
    MULT_OUT = 3
    ONE = 4


class Variable:
    __slots__ = ("kind", "index", "_hash")

    def __init__(self, kind: VarKind, index: int = 0):
        self.kind = kind
        self.index = index
        # precomputed: Variable hashing is hot in LC simplification
        self._hash = (int(kind) << 32) | index

    @staticmethod
    def One() -> "Variable":
        return _ONE

    @staticmethod
    def committed(i: int) -> "Variable":
        return Variable(VarKind.COMMITTED, i)

    @staticmethod
    def mult_left(i: int) -> "Variable":
        return Variable(VarKind.MULT_LEFT, i)

    @staticmethod
    def mult_right(i: int) -> "Variable":
        return Variable(VarKind.MULT_RIGHT, i)

    @staticmethod
    def mult_out(i: int) -> "Variable":
        return Variable(VarKind.MULT_OUT, i)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Variable)
            and self.kind == other.kind
            and self.index == other.index
        )

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        if self.kind == VarKind.ONE:
            return "Var(1)"
        return f"Var({self.kind.name}, {self.index})"

    # arithmetic sugar: promote to LinearCombination
    def lc(self) -> "LinearCombination":
        return LinearCombination([(self, Scalar.one())])

    def __add__(self, other):
        return self.lc() + other

    def __radd__(self, other):
        return _coerce(other) + self.lc()

    def __sub__(self, other):
        return self.lc() - other

    def __rsub__(self, other):
        return _coerce(other) - self.lc()

    def __mul__(self, scalar):
        return self.lc() * scalar

    def __rmul__(self, scalar):
        return self.lc() * scalar

    def __neg__(self):
        return -self.lc()


_ONE = Variable(VarKind.ONE, 0)


def _coerce(x) -> "LinearCombination":
    if isinstance(x, LinearCombination):
        return x
    if isinstance(x, Variable):
        return x.lc()
    if isinstance(x, Scalar):
        return LinearCombination([(_ONE, x)])
    if isinstance(x, int):
        return LinearCombination([(_ONE, Scalar(x))])
    raise TypeError(f"cannot convert {type(x)} to LinearCombination")


class LinearCombination:
    """Sparse sum of (Variable, Scalar) terms."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms: list[tuple[Variable, Scalar]] = list(terms) if terms else []

    @staticmethod
    def default() -> "LinearCombination":
        return LinearCombination()

    @staticmethod
    def from_(x) -> "LinearCombination":
        return _coerce(x)

    def get_terms(self) -> list[tuple[Variable, Scalar]]:
        return list(self.terms)

    def __add__(self, other) -> "LinearCombination":
        o = _coerce(other)
        return LinearCombination(self.terms + o.terms)

    __radd__ = __add__

    def __sub__(self, other) -> "LinearCombination":
        o = _coerce(other)
        return LinearCombination(
            self.terms + [(v, -c) for (v, c) in o.terms]
        )

    def __rsub__(self, other) -> "LinearCombination":
        return _coerce(other) - self

    def __mul__(self, scalar) -> "LinearCombination":
        s = scalar if isinstance(scalar, Scalar) else Scalar(int(scalar))
        return LinearCombination([(v, c * s) for (v, c) in self.terms])

    __rmul__ = __mul__

    def __neg__(self) -> "LinearCombination":
        return LinearCombination([(v, -c) for (v, c) in self.terms])

    def simplify(self) -> "LinearCombination":
        """Merge duplicate variables (the gadget-level ``simplify_lc``,
        ``reference/src/gadget_poseidon.rs:99-112``); drops zero terms.

        Accumulates raw ints (one reduction per variable at the end) - this
        runs once per partial Poseidon round and dominates synthesis time.
        """
        acc: dict[Variable, int] = {}
        get = acc.get
        for v, c in self.terms:
            acc[v] = get(v, 0) + c.v
        out = []
        for v, c in acc.items():
            cv = c % _L
            if cv:
                out.append((v, Scalar(cv)))
        return LinearCombination(out)

    def __repr__(self) -> str:
        return " + ".join(f"{c.v}*{v}" for v, c in self.terms) or "0"
