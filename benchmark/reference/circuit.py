"""The membership circuits as R1CS, recorded once and flattened per proof.

The gadgets follow lovesh/bulletproofs-r1cs-gadgets.  Each circuit kind
is a file of its own, ``circuits/<kind>.py`` beside this one, found by
the configuration's ``circuit``: its level gadget, its commitment layout,
its tree and its closing constraints.  Shared here are the recorder and
``gadget_poseidon.rs`` (the
inverse S-box as upstream writes it: 3 multipliers that make the output
the inverse of a fresh nonzero wire, which upstream does not tie to the
S-box's input).  The multiplier and constraint order is the Bulletproofs
R1CS verifier's: ``multiply`` adds its two linking constraints, left
first.

Every level is the same segment with its indices shifted, so the
recorder runs two levels (the leaf level A and a chained level B) and
``weights`` stamps them ``depth`` times; it returns the verifier's
flattened weights: w_X[i] = sum_q z^(q+1) coef_q(X_i) for the
multiplier wires and minus that for the commitments and the constant.
"""

from __future__ import annotations

from ..named import load
from .poseidon import L, PADDING_CONST, Params

ONE = ("1", 0)


class LC(dict):
    """A linear combination: variable -> coefficient mod l."""

    @staticmethod
    def of(var, coef: int = 1) -> "LC":
        return LC({var: coef % L})

    def __add__(self, other: "LC") -> "LC":
        out = LC(self)
        for k, v in other.items():
            out[k] = (out.get(k, 0) + v) % L
        return out

    def __sub__(self, other: "LC") -> "LC":
        out = LC(self)
        for k, v in other.items():
            out[k] = (out.get(k, 0) - v) % L
        return out

    def scale(self, c: int) -> "LC":
        return LC({k: v * c % L for k, v in self.items()})

    def plus(self, c: int) -> "LC":
        return self + LC.of(ONE, c)


class Recorder:
    """The verifier's constraint system without assignments."""

    def __init__(self):
        self.n = 0
        self.constraints: list[LC] = []
        self._pending = None

    def multiply(self, left: LC, right: LC):
        i = self.n
        self.n += 1
        self.constraints.append(left - LC.of(("L", i)))
        self.constraints.append(right - LC.of(("R", i)))
        return ("L", i), ("R", i), ("O", i)

    def allocate(self):
        if self._pending is None:
            self._pending = self.n
            self.n += 1
            return ("L", self._pending)
        i, self._pending = self._pending, None
        return ("R", i)

    def allocate_multiplier(self):
        i = self.n
        self.n += 1
        return ("L", i), ("R", i), ("O", i)

    def constrain(self, lc: LC) -> None:
        self.constraints.append(lc)


def inverse_sbox(cs: Recorder, _input: LC, _key: int):
    var_l = cs.allocate()
    var_r = cs.allocate()
    var_o = ("O", var_r[1])
    one_minus_y = LC.of(ONE) - LC.of(ONE)
    _, _, o1 = cs.multiply(LC.of(var_l), one_minus_y)
    cs.constrain(LC.of(o1))
    _, _, o2 = cs.multiply(LC.of(var_l), LC.of(var_r))
    cs.constrain(LC.of(o2) - LC.of(ONE))
    cs.constrain(LC.of(var_o).plus(-1))
    return var_r


def permutation(cs: Recorder, inputs: list[LC], p: Params) -> list[LC]:
    w, keys, mds = p.width, p.keys, p.mds
    state, off = list(inputs), 0

    def mix(outs):
        nxt = []
        for i in range(w):
            acc = LC()
            for j in range(w):
                m = mds[i][j]
                for var, c in outs[j].items():
                    acc[var] = (acc.get(var, 0) + m * c) % L
            nxt.append(acc)
        return nxt

    def full():
        nonlocal state, off
        outs = [LC.of(inverse_sbox(cs, state[i], keys[off + i]))
                for i in range(w)]
        off += w
        state = mix(outs)

    for _ in range(p.full_begin):
        full()
    for _ in range(p.partial):
        outs = [state[i].plus(keys[off + i]) for i in range(w - 1)]
        outs.append(LC.of(inverse_sbox(cs, state[w - 1], keys[off + w - 1])))
        off += w
        state = mix(outs)
    for _ in range(p.full_end):
        full()
    return state


class Circuit:
    """The membership circuit of one configuration (``kind`` the name of
    a file in ``circuits/``, ``depth`` levels) and its commitment layout,
    which the kind states: the committed values, then the statics."""

    def __init__(self, kind: str, depth: int, p: Params):
        self.kind = load("reference/circuits", kind)
        self.depth, self.p = depth, p
        cs = Recorder()
        mark = lambda name: ("V", name)  # noqa: E731
        nstat = self.kind.statics_count(p)
        statics = [LC.of(mark(("s", j))) for j in range(nstat)]
        out_a, bits = self.kind.level(cs, LC.of(mark("leaf")), "A", statics,
                                      p, mark)
        n_a, c_a = cs.n, len(cs.constraints)
        out_b, _ = self.kind.level(cs, out_a, "B", statics, p, mark)
        if cs.n != 2 * n_a or len(cs.constraints) != 2 * c_a:
            raise AssertionError("the two recorded levels differ in size")
        self.bits = bits  # local L indices of a level's bits, if any
        self.npl, self.cpl, self.nstat = n_a, c_a, nstat
        self.tpl = {"A": cs.constraints[:c_a], "B": cs.constraints[c_a:]}
        self.out = {"A": out_a, "B": out_b}
        self.n = depth * n_a
        self.num_v = self.kind.num_v(depth) + nstat

    # ---------------------------------------------------------- layout
    def _vmap(self, level: int) -> dict:
        """Marker -> commitment index at `level` (leaf level 0)."""
        out = {("s", j): self.num_v - self.nstat + j for j in range(self.nstat)}
        out["leaf"] = 0
        out.update(self.kind.markers(level, self.depth))
        return out

    def values(self, key: int, value: int, siblings: list[list[int]]) -> list[int]:
        """The committed values (without the statics) for a leaf, from
        the tree's siblings (leaf level first)."""
        return self.kind.values(key, value, siblings, self.depth)

    def statics(self) -> list[int]:
        return [0, PADDING_CONST] + [0] * (self.nstat - 2)

    # ---------------------------------------------------------- flatten
    def weights(self, z: int, root: int):
        """(wL, wR, wO, wV, wc) of the circuit with public root `root`."""
        n, npl, cpl = self.n, self.npl, self.cpl
        w = {k: [0] * n for k in "LRO"}
        wV = [0] * self.num_v
        wc = 0
        zc = pow(z, cpl, L)
        zpow = [z]
        for _ in range(cpl - 1):
            zpow.append(zpow[-1] * z % L)
        # per template: (kind, local index) -> sum_q z^(q+1) coef
        folded = {}
        for tag, cons in self.tpl.items():
            acc: dict = {}
            for q, lc in enumerate(cons):
                zq = zpow[q]
                for var, c in lc.items():
                    acc[var] = (acc.get(var, 0) + zq * c) % L
            folded[tag] = acc
        zk = 1
        for level in range(self.depth):
            tag = "A" if level == 0 else "B"
            shift = level * npl - (0 if level == 0 else npl)
            vmap = self._vmap(level)
            for (kind, idx), c in folded[tag].items():
                if kind in "LRO":
                    j = idx + shift
                    w[kind][j] = (w[kind][j] + zk * c) % L
                elif kind == "V":
                    v = vmap[idx]
                    wV[v] = (wV[v] - zk * c) % L
                else:
                    wc = (wc - zk * c) % L
            zk = zk * zc % L
        # the closing constraints: the kind's own, then the root
        q = self.depth * cpl
        tail = self.kind.closing(self.depth, npl, self.bits)
        out = self.out["A" if self.depth == 1 else "B"]
        shift = (self.depth - 1) * npl - (0 if self.depth == 1 else npl)
        root_lc = LC({(k[0], k[1] + shift) if k[0] in "LRO" else k: c
                      for k, c in out.items()})
        tail.append(root_lc.plus(-root))
        zq = pow(z, q + 1, L)
        last = self._vmap(self.depth - 1)
        for lc in tail:
            for (kind, idx), c in lc.items():
                if kind in "LRO":
                    w[kind][idx] = (w[kind][idx] + zq * c) % L
                elif kind == "V":
                    wV[last[idx]] = (wV[last[idx]] - zq * c) % L
                else:
                    wc = (wc - zq * c) % L
            zq = zq * z % L
        return w["L"], w["R"], w["O"], wV, wc
