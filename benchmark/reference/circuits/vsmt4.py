"""VSMT-4 (``gadget_vsmt_4.rs``): per base-4 digit, two
booleanity-checked bits, their 4 products, 13 multipliers placing the
path node among its 3 siblings, then a Poseidon 4:1 hash; at the end the
key recomposed from the bits.  Commitments: the leaf value, the key, the
3 * depth siblings root level first (each level's in child order), then
the statics."""

from benchmark.reference.circuit import LC, permutation
from benchmark.reference.poseidon import L, Tree

ARITY = 4


def tree(depth: int, items: dict, p) -> Tree:
    return Tree(ARITY, depth, items, p)


def statics_count(p) -> int:
    return p.width - 4


def level(cs, cur: LC, tag: str, statics: list, p, mark):
    """One level of the gadget, its wires marked by `tag`: (the level's
    output, the local L indices of its two digit bits)."""
    n1, n2, n3 = (mark(f"n{c}{tag}") for c in (1, 2, 3))
    b0, b0_1, o = cs.allocate_multiplier()
    cs.constrain(LC.of(o))
    cs.constrain((LC.of(b0) + LC.of(b0_1)).plus(-1))
    b1, b1_1, o = cs.allocate_multiplier()
    cs.constrain(LC.of(o))
    cs.constrain((LC.of(b1) + LC.of(b1_1)).plus(-1))
    mul = lambda a, b: LC.of(cs.multiply(a, b)[2])  # noqa: E731
    v = LC.of
    p00 = mul(v(b0_1), v(b1_1))
    p01 = mul(v(b0_1), v(b1))
    p10 = mul(v(b0), v(b1_1))
    p11 = mul(v(b0), v(b1))
    N1, N2, N3 = v(n1), v(n2), v(n3)
    c0 = mul(p00, cur) + mul(v(b0), N1) + mul(p01, N1)
    c1 = mul(p00, N1) + mul(p10, cur) + mul(p01, N2) + mul(p11, N2)
    c2 = mul(v(b1_1), N2) + mul(p01, cur) + mul(p11, N3)
    c3 = mul(v(b1_1), N3) + mul(p01, N3) + mul(p11, cur)
    state = permutation(cs, [statics[0], c0, c1, c2, c3, statics[1]], p)
    return state[1], (b0[1], b1[1])


def num_v(depth: int) -> int:
    """Committed values besides the statics."""
    return 2 + 3 * depth


def markers(level: int, depth: int) -> dict:
    """The level's markers -> commitment index (and the key's)."""
    base = 2 + 3 * (depth - 1 - level)
    out = {"key": 1}
    for tag in "AB":
        for c in range(3):
            out[f"n{c + 1}{tag}"] = base + c
    return out


def values(key: int, value: int, siblings: list, depth: int) -> list:
    flat = [x for lvl in reversed(siblings) for x in lvl]
    return [value, key] + flat


def closing(depth: int, npl: int, bits) -> list:
    """Before the root's: the key recomposed from each level's bits."""
    lc, e4 = LC.of(("V", "key"), -1), 1
    for level in range(depth):
        b0 = ("L", level * npl + bits[0])
        b1 = ("L", level * npl + bits[1])
        lc = lc + LC.of(b1, 2 * e4) + LC.of(b0, e4)
        e4 = e4 * 4 % L
    return [lc]
