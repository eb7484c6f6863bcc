"""Width-2 vanilla sparse Merkle tree + membership-proof circuit ("VSMT").

Reference: ``reference/src/gadget_vsmt_2.rs``: host tree of depth 253
(:23) keyed by Poseidon-2:1 (inverse S-box) node hashes, with an
empty-subtree hash cache (:40-52); circuit gadget :171-209 selects
left/right per level from a committed index bit (4 multipliers/level) and
hashes up to the root.

Soundness note: like the reference, the circuit does NOT booleanity-constrain
the index bits (the prover commits them, :305-314).  We close that gap by
default (``constrain_index_bits=True``) while allowing exact reference parity
with ``constrain_index_bits=False``.

The host tree runs on the host Poseidon (each ``update`` is a strictly
sequential 253-level hash chain — no batch to exploit); the batched TPU
Poseidon kernel (:class:`..ops.poseidon.DevicePoseidon`) serves the
demo pipeline and bulk witness hashing, not this tree.
"""

from __future__ import annotations

from ..core.scalar import Scalar
from ..core.linear_combination import Variable, LinearCombination
from ..gadgets.r1cs_utils import AllocatedScalar, constrain_lc_with_scalar
from ..gadgets.scalar_utils import ScalarBits, get_bits
from ..gadgets.poseidon import (
    PoseidonParams,
    Poseidon_hash_2,
    Poseidon_hash_2_constraints,
    SboxType,
)

from ..utils.config import DEFAULT_CONFIG

TREE_DEPTH = DEFAULT_CONFIG.trees.vsmt2_depth  # gadget_vsmt_2.rs:23


class VanillaSparseMerkleTree:
    """Host-side sparse Merkle tree (depth 253, Poseidon-2:1 inverse S-box)."""

    def __init__(self, hash_params: PoseidonParams, depth: int = TREE_DEPTH):
        self.depth = depth
        self.hash_params = hash_params
        self.db: dict[bytes, tuple[Scalar, Scalar]] = {}
        empty_tree_hashes = [Scalar.zero()]
        for i in range(1, depth + 1):
            prev = empty_tree_hashes[i - 1]
            new = Poseidon_hash_2(prev, prev, hash_params, SboxType.Inverse)
            self.db[new.to_bytes()] = (prev, prev)
            empty_tree_hashes.append(new)
        self.empty_tree_hashes = empty_tree_hashes
        self.root = empty_tree_hashes[depth]

    def update(self, idx: Scalar, val: Scalar) -> Scalar:
        sidenodes: list[Scalar] = []
        self.get(idx, sidenodes)
        cur_idx = ScalarBits.from_scalar(idx, self.depth)
        cur_val = val
        for _ in range(self.depth):
            side_elem = sidenodes.pop()
            if cur_idx.is_lsb_set():
                h = Poseidon_hash_2(
                    side_elem, cur_val, self.hash_params, SboxType.Inverse
                )
                self.db[h.to_bytes()] = (side_elem, cur_val)
            else:
                h = Poseidon_hash_2(
                    cur_val, side_elem, self.hash_params, SboxType.Inverse
                )
                self.db[h.to_bytes()] = (cur_val, side_elem)
            cur_idx.shr()
            cur_val = h
        self.root = cur_val
        return cur_val

    def get(self, idx: Scalar, proof: list[Scalar] | None = None) -> Scalar:
        """Walk root -> leaf; when ``proof`` is a list, fill it with the
        sibling nodes (root level first)."""
        cur_idx = ScalarBits.from_scalar(idx, self.depth)
        cur_node = self.root
        for _ in range(self.depth):
            left, right = self.db[cur_node.to_bytes()]
            if cur_idx.is_msb_set():
                cur_node = right
                if proof is not None:
                    proof.append(left)
            else:
                cur_node = left
                if proof is not None:
                    proof.append(right)
            cur_idx.shl()
        return cur_node

    def verify_proof(
        self, idx: Scalar, val: Scalar, proof: list[Scalar], root: Scalar | None = None
    ) -> bool:
        cur_idx = ScalarBits.from_scalar(idx, self.depth)
        cur_val = val
        for i in range(self.depth):
            sibling = proof[self.depth - 1 - i]
            if cur_idx.is_lsb_set():
                cur_val = Poseidon_hash_2(
                    sibling, cur_val, self.hash_params, SboxType.Inverse
                )
            else:
                cur_val = Poseidon_hash_2(
                    cur_val, sibling, self.hash_params, SboxType.Inverse
                )
            cur_idx.shr()
        target = root if root is not None else self.root
        return cur_val == target


def vsmt_level_gadget(
    cs,
    cur: LinearCombination,
    bit: Variable,
    node: Variable,
    statics_lcs: list[LinearCombination],
    poseidon_params: PoseidonParams,
    constrain_index_bits: bool,
) -> LinearCombination:
    """One tree level: the left/right selection (4 multipliers,
    ``gadget_vsmt_2.rs:194-200``) followed by the Poseidon-2:1 hash
    constraints.  Shared by the loop gadget below and the template compiler
    (:mod:`.compiled`), which stamps this segment ``depth`` times."""
    one_minus_bit = Variable.One() - bit

    if constrain_index_bits:
        # soundness fix over the reference: force bit in {0, 1}
        _, _, bo = cs.multiply(bit.lc(), one_minus_bit)
        cs.constrain(bo.lc())

    _, _, left_1 = cs.multiply(one_minus_bit, cur)
    _, _, left_2 = cs.multiply(bit.lc(), node.lc())
    left = left_1 + left_2

    _, _, right_1 = cs.multiply(bit.lc(), cur)
    _, _, right_2 = cs.multiply(Variable.One() - bit, node.lc())
    right = right_1 + right_2

    return Poseidon_hash_2_constraints(
        cs, left, right, statics_lcs, poseidon_params, SboxType.Inverse
    )


def vanilla_merkle_tree_verif_gadget(
    cs,
    depth: int,
    root: Scalar,
    leaf_val: AllocatedScalar,
    leaf_index_bits: list[AllocatedScalar],
    proof_nodes: list[AllocatedScalar],
    statics: list[AllocatedScalar],
    poseidon_params: PoseidonParams,
    constrain_index_bits: bool = DEFAULT_CONFIG.trees.constrain_index_bits,
) -> None:
    """Membership circuit (``gadget_vsmt_2.rs:171-209``).

    Per level: left = (1-b)*cur + b*sibling, right = b*cur + (1-b)*sibling
    (4 multipliers), then Poseidon-2:1 constraints; finally root equality.
    """
    statics_lcs = [s.variable.lc() for s in statics]
    prev_hash = LinearCombination()

    for i in range(depth):
        cur = leaf_val.variable.lc() if i == 0 else prev_hash
        prev_hash = vsmt_level_gadget(
            cs,
            cur,
            leaf_index_bits[i].variable,
            proof_nodes[i].variable,
            statics_lcs,
            poseidon_params,
            constrain_index_bits,
        )

    constrain_lc_with_scalar(cs, prev_hash, root)


def leaf_index_bit_scalars(idx: Scalar, depth: int = TREE_DEPTH) -> list[Scalar]:
    """The per-level index bits the prover commits (LSB first,
    ``gadget_vsmt_2.rs:305-314``)."""
    return [Scalar(b) for b in get_bits(idx, depth)]
