"""Poseidon over the ristretto scalar field, in Python ints, and the two
sparse Merkle trees of the configurations built with it.

The constants are a frozen copy of the upstream gadget's data
(``poseidon_constants.json``: lovesh/bulletproofs-r1cs-gadgets
``src/poseidon_constants.rs``, loaded as upstream's
``get_scalar_from_hex`` loads them: the hex bytes read little-endian).
The MDS matrix is checked against its Cauchy construction.
"""

from __future__ import annotations

import json
import os

L = 2**252 + 27742317777372353535851937790883648493
PADDING_CONST = 101
_DATA = os.path.join(os.path.dirname(__file__), "poseidon_constants.json")


def _le(h: str) -> int:
    return int.from_bytes(bytes.fromhex(h[2:] if h[:2] in ("0x", "0X") else h),
                          "little") % L


class Params:
    def __init__(self, width: int, full_begin: int, partial: int,
                 full_end: int):
        with open(_DATA) as f:
            data = json.load(f)
        self.width = width
        self.full_begin, self.partial, self.full_end = full_begin, partial, full_end
        rounds = full_begin + partial + full_end
        self.keys = [_le(h) for h in data["round_consts_hex"][:rounds * width]]
        if len(self.keys) != rounds * width:
            raise ValueError("not enough round constants")
        if len(data["mds_hex"]) != width:
            raise ValueError(f"no MDS matrix of width {width}")
        for i, row in enumerate(data["mds_hex"]):
            for j, h in enumerate(row):
                if int(h, 16) != pow(i + width + j, L - 2, L):
                    raise ValueError("MDS data is not the Cauchy matrix")
        self.mds = [[_le(h) for h in row] for row in data["mds_hex"]]


def _inv(x: int) -> int:
    return pow(x, -1, L) if x else 0


def _inv_all(xs: list[int]) -> list[int]:
    """Every element's inverse (0 for 0) with one modular inversion."""
    pre, acc = [], 1
    for x in xs:
        pre.append(acc)
        acc = acc * (x or 1) % L
    inv = pow(acc, -1, L)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        x = xs[i] or 1
        out[i] = inv * pre[i] % L if xs[i] else 0
        inv = inv * x % L
    return out


def permute_all(states: list[list[int]], p: Params) -> list[list[int]]:
    """The permutation with the inverse S-box x -> x^(l-2), applied to
    each state; each round's S-boxes share one modular inversion."""
    w, keys, mds = p.width, p.keys, p.mds
    mix = _mix6(mds) if w == 6 else (
        lambda s: [sum(m * x for m, x in zip(row, s)) % L for row in mds])
    cur = [list(s) for s in states]
    full = [True] * p.full_begin + [False] * p.partial + [True] * p.full_end
    for r, is_full in enumerate(full):
        k = keys[w * r:w * (r + 1)]
        cur = [[(x + c) % L for x, c in zip(s, k)] for s in cur]
        if is_full:
            flat = _inv_all([x for s in cur for x in s])
            cur = [flat[w * i:w * (i + 1)] for i in range(len(cur))]
        else:
            last = _inv_all([s[-1] for s in cur])
            for s, v in zip(cur, last):
                s[-1] = v
        cur = [mix(s) for s in cur]
    return cur


def _mix6(mds):
    """The width-6 MDS product, written out."""
    (a0, a1, a2, a3, a4, a5), (b0, b1, b2, b3, b4, b5), \
        (c0, c1, c2, c3, c4, c5), (d0, d1, d2, d3, d4, d5), \
        (e0, e1, e2, e3, e4, e5), (f0, f1, f2, f3, f4, f5) = mds

    def mix(s):
        x0, x1, x2, x3, x4, x5 = s
        return [(a0 * x0 + a1 * x1 + a2 * x2 + a3 * x3 + a4 * x4 + a5 * x5) % L,
                (b0 * x0 + b1 * x1 + b2 * x2 + b3 * x3 + b4 * x4 + b5 * x5) % L,
                (c0 * x0 + c1 * x1 + c2 * x2 + c3 * x3 + c4 * x4 + c5 * x5) % L,
                (d0 * x0 + d1 * x1 + d2 * x2 + d3 * x3 + d4 * x4 + d5 * x5) % L,
                (e0 * x0 + e1 * x1 + e2 * x2 + e3 * x3 + e4 * x4 + e5 * x5) % L,
                (f0 * x0 + f1 * x1 + f2 * x2 + f3 * x3 + f4 * x4 + f5 * x5) % L]
    return mix


class Tree:
    """A sparse Merkle tree of arity 2 or 4 and `depth` levels holding
    ``items`` (key -> value), built bottom up.  A node at level k (leaves
    at 0) sits at position key >> (k log2 arity); empty subtrees hash to
    the chain of empty hashes."""

    def __init__(self, arity: int, depth: int, items: dict, p: Params):
        self.arity, self.depth, self.p = arity, depth, p
        self.shift = arity.bit_length() - 1
        self.empty = [0]
        levels = [dict(items)]
        for k in range(depth):
            jobs = sorted({q >> self.shift for q in levels[k]})
            kids = [[levels[k].get((pos << self.shift) | c, self.empty[k])
                     for c in range(arity)] for pos in jobs]
            kids.append([self.empty[k]] * arity)
            if arity == 2:
                states = [[0, a, b, PADDING_CONST, 0, 0] for a, b in kids]
            else:
                states = [[0] + list(c) + [PADDING_CONST] for c in kids]
            out = [s[1] for s in permute_all(states, p)]
            self.empty.append(out.pop())
            levels.append(dict(zip(jobs, out)))
        self.levels = levels
        self.root = levels[depth][0] if levels[depth] else self.empty[depth]

    def siblings(self, key: int) -> list[list[int]]:
        """Per level, leaf level first, the other children of the path's
        node in child order."""
        out = []
        for k in range(self.depth):
            pos = key >> (self.shift * k)
            base = pos >> self.shift << self.shift
            out.append([self.levels[k].get(base | c, self.empty[k])
                        for c in range(self.arity) if base | c != pos])
        return out
