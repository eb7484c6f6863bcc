"""VSMT-2 (``gadget_vsmt_2.rs``): per level, select left and right from
the committed index bit (4 multipliers), then a Poseidon 2:1 hash.
Commitments: the leaf value, the depth index bits (leaf level first), the
depth sibling nodes (leaf level first), then the statics."""

from benchmark.reference.circuit import LC, ONE, permutation
from benchmark.reference.poseidon import Tree

ARITY = 2


def tree(depth: int, items: dict, p) -> Tree:
    return Tree(ARITY, depth, items, p)


def statics_count(p) -> int:
    return p.width - 2


def level(cs, cur: LC, tag: str, statics: list, p, mark):
    """One level of the gadget, its wires marked by `tag`: (the level's
    output, None: no bits to recompose)."""
    bit, node = mark("bit" + tag), mark("node" + tag)
    one_minus_bit = LC.of(ONE) - LC.of(bit)
    _, _, l1 = cs.multiply(one_minus_bit, cur)
    _, _, l2 = cs.multiply(LC.of(bit), LC.of(node))
    _, _, r1 = cs.multiply(LC.of(bit), cur)
    _, _, r2 = cs.multiply(LC.of(ONE) - LC.of(bit), LC.of(node))
    left = LC.of(l1) + LC.of(l2)
    right = LC.of(r1) + LC.of(r2)
    state = permutation(cs, [statics[0], left, right] + list(statics[1:]), p)
    return state[1], None


def num_v(depth: int) -> int:
    """Committed values besides the statics."""
    return 1 + 2 * depth


def markers(level: int, depth: int) -> dict:
    """The level's markers -> commitment index."""
    out = {}
    for tag in "AB":
        out["bit" + tag] = 1 + level
        out["node" + tag] = 1 + depth + level
    return out


def values(key: int, value: int, siblings: list, depth: int) -> list:
    bits = [(key >> i) & 1 for i in range(depth)]
    return [value] + bits + [s[0] for s in siblings]


def closing(depth: int, npl: int, bits) -> list:
    """Constraints before the root's: none."""
    return []
