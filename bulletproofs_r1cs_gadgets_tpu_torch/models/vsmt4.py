"""Width-4 sparse Merkle tree + membership circuit.

Reference: ``reference/src/gadget_vsmt_4.rs``: 4-ary tree of depth 128
(:25), base-4 path digits from the leaf index bytes (:28, LeafIndexBytes=32);
host ops :40-165; circuit :199-312: per digit, two booleanity-constrained
bits, the 4 bit-products, arithmetic placement of the hidden node among the
3 siblings (13 multipliers), a Poseidon-4:1 hash, and the leaf-index
recomposition constraint sum((2*b1 + b0) * 4^i) == idx.
"""

from __future__ import annotations

from ..core.scalar import Scalar
from ..core.linear_combination import LinearCombination
from ..gadgets.r1cs_utils import AllocatedScalar, constrain_lc_with_scalar
from ..gadgets.scalar_utils import get_base_4_repr
from ..gadgets.poseidon import (
    PoseidonParams,
    Poseidon_hash_4,
    Poseidon_hash_4_constraints,
    SboxType,
)

from ..utils.config import DEFAULT_CONFIG

TREE_DEPTH_4 = DEFAULT_CONFIG.trees.vsmt4_depth  # gadget_vsmt_4.rs:25
LEAF_INDEX_BYTES = TREE_DEPTH_4 // 4


class VanillaSparseMerkleTree4:
    """Host-side 4-ary sparse Merkle tree (Poseidon-4:1, inverse S-box)."""

    def __init__(self, hash_params: PoseidonParams, depth: int = TREE_DEPTH_4):
        if depth % 4 != 0:
            raise ValueError("Tree depth should be a multiple of 4")
        self.depth = depth
        self.hash_params = hash_params
        self.db: dict[bytes, list[Scalar]] = {}
        empty = [Scalar.zero()]
        for i in range(1, depth + 1):
            prev = empty[i - 1]
            children = [prev, prev, prev, prev]
            new = Poseidon_hash_4(children, hash_params, SboxType.Inverse)
            self.db[new.to_bytes()] = children
            empty.append(new)
        self.empty_tree_hashes = empty
        self.root = empty[depth]

    def _digits(self, idx: Scalar) -> list[int]:
        return get_base_4_repr(idx, self.depth // 4)

    def update(self, idx: Scalar, val: Scalar) -> Scalar:
        sidenodes: list[list[Scalar]] = []
        self.get(idx, sidenodes)
        cur_digits = list(reversed(self._digits(idx)))
        cur_val = val
        for d in cur_digits:
            siblings = list(sidenodes.pop())
            siblings.insert(d, cur_val)
            h = Poseidon_hash_4(siblings, self.hash_params, SboxType.Inverse)
            self.db[h.to_bytes()] = siblings
            cur_val = h
        self.root = cur_val
        return cur_val

    def get(self, idx: Scalar, proof: list[list[Scalar]] | None = None) -> Scalar:
        cur_node = self.root
        for d in self._digits(idx):
            children = self.db[cur_node.to_bytes()]
            cur_node = children[d]
            if proof is not None:
                proof.append([c for i, c in enumerate(children) if i != d])
        return cur_node

    def verify_proof(
        self,
        idx: Scalar,
        val: Scalar,
        proof: list[list[Scalar]],
        root: Scalar | None = None,
    ) -> bool:
        cur_digits = list(reversed(self._digits(idx)))
        cur_val = val
        for i, d in enumerate(cur_digits):
            p = list(proof[self.depth - 1 - i])
            p.insert(d, cur_val)
            cur_val = Poseidon_hash_4(p, self.hash_params, SboxType.Inverse)
        target = root if root is not None else self.root
        return cur_val == target


def vsmt4_digit_gadget(
    cs,
    prev_hash: LinearCombination,
    bit_pair,
    N1: LinearCombination,
    N2: LinearCombination,
    N3: LinearCombination,
    statics_lcs: list[LinearCombination],
    poseidon_params: PoseidonParams,
):
    """One base-4 digit level (``gadget_vsmt_4.rs:226-301``): booleanity-
    constrained digit bits, the 4 bit-products, arithmetic placement of the
    hidden node among siblings [N1, N2, N3] (13 multipliers), and the
    Poseidon-4:1 hash.  ``bit_pair`` is ``(bit0, bit1)`` on the prover side
    or ``None`` on the verifier/recording side.  Returns
    ``(new_hash, b0, b1)`` — the bit variables feed the caller's leaf-index
    recomposition constraint.  Shared by the generic loop gadget below and
    the template compiler (:mod:`.compiled`), which stamps this segment
    ``depth`` times."""
    if bit_pair is not None:
        bit0, bit1 = bit_pair
        b0, b0_1, o = cs.allocate_multiplier((Scalar(bit0), Scalar(1 - bit0)))
    else:
        b0, b0_1, o = cs.allocate_multiplier(None)
    cs.constrain(o.lc())
    cs.constrain(b0 + (b0_1 - Scalar.one()))

    if bit_pair is not None:
        b1, b1_1, o = cs.allocate_multiplier((Scalar(bit1), Scalar(1 - bit1)))
    else:
        b1, b1_1, o = cs.allocate_multiplier(None)
    cs.constrain(o.lc())
    cs.constrain(b1 + (b1_1 - Scalar.one()))

    _, _, b0_1_b1_1 = cs.multiply(b0_1.lc(), b1_1.lc())
    _, _, b0_1_b1 = cs.multiply(b0_1.lc(), b1.lc())
    _, _, b0_b1_1 = cs.multiply(b0.lc(), b1_1.lc())
    _, _, b0_b1 = cs.multiply(b0.lc(), b1.lc())

    _, _, c0_1 = cs.multiply(b0_1_b1_1.lc(), prev_hash)
    _, _, c0_2 = cs.multiply(b0.lc(), N1)
    _, _, c0_3 = cs.multiply(b0_1_b1.lc(), N1)
    c0 = c0_1 + c0_2 + c0_3

    _, _, c1_1 = cs.multiply(b0_1_b1_1.lc(), N1)
    _, _, c1_2 = cs.multiply(b0_b1_1.lc(), prev_hash)
    _, _, c1_3 = cs.multiply(b0_1_b1.lc(), N2)
    _, _, c1_4 = cs.multiply(b0_b1.lc(), N2)
    c1 = c1_1 + c1_2 + c1_3 + c1_4

    _, _, c2_1 = cs.multiply(b1_1.lc(), N2)
    _, _, c2_2 = cs.multiply(b0_1_b1.lc(), prev_hash)
    _, _, c2_3 = cs.multiply(b0_b1.lc(), N3)
    c2 = c2_1 + c2_2 + c2_3

    _, _, c3_1 = cs.multiply(b1_1.lc(), N3)
    _, _, c3_2 = cs.multiply(b0_1_b1.lc(), N3)
    _, _, c3_3 = cs.multiply(b0_b1.lc(), prev_hash)
    c3 = c3_1 + c3_2 + c3_3

    new_hash = Poseidon_hash_4_constraints(
        cs, [c0, c1, c2, c3], statics_lcs, poseidon_params, SboxType.Inverse
    )
    return new_hash, b0, b1


def vanilla_merkle_tree_4_verif_gadget(
    cs,
    depth: int,
    root: Scalar,
    leaf_val: AllocatedScalar,
    leaf_index: AllocatedScalar,
    proof_nodes: list[AllocatedScalar],
    statics: list[AllocatedScalar],
    poseidon_params: PoseidonParams,
) -> None:
    """Membership circuit (``gadget_vsmt_4.rs:199-312``).

    The hidden node N (path child) is placed among siblings [N1, N2, N3]
    arithmetically from the digit bits b0, b1 (derivation comment
    ``gadget_vsmt_4.rs:167-198``):
      c0 = (1-b0)(1-b1)N + b0*N1 + (1-b0)b1*N1
      c1 = (1-b0)(1-b1)N1 + (1-b1)b0*N + (1-b0)b1*N2 + b0*b1*N2
      c2 = (1-b1)N2 + (1-b0)b1*N + b0*b1*N3
      c3 = (1-b1)N3 + (1-b0)b1*N3 + b1*b0*N
    """
    prev_hash = leaf_val.variable.lc()
    proof_nodes = list(proof_nodes)
    statics_lcs = [s.variable.lc() for s in statics]

    constraint_leaf_index = [(leaf_index.variable, -Scalar.one())]
    exp_4 = Scalar.one()
    two = Scalar(2)
    four = Scalar(4)
    leaf_index_bytes = depth // 4

    for i in range(leaf_index_bytes):
        for j in range(4):
            if leaf_index.assignment is not None:
                byte = leaf_index.assignment.byte(i)
                bit_pair = ((byte >> (2 * j)) & 1, (byte >> (2 * j + 1)) & 1)
            else:
                bit_pair = None

            N3 = proof_nodes.pop().variable.lc()
            N2 = proof_nodes.pop().variable.lc()
            N1 = proof_nodes.pop().variable.lc()

            prev_hash, b0, b1 = vsmt4_digit_gadget(
                cs, prev_hash, bit_pair, N1, N2, N3, statics_lcs,
                poseidon_params,
            )
            constraint_leaf_index.append((b1, two * exp_4))
            constraint_leaf_index.append((b0, exp_4))
            exp_4 = exp_4 * four

    cs.constrain(LinearCombination(constraint_leaf_index))
    constrain_lc_with_scalar(cs, prev_hash, root)
