"""Optimized (compressed) sparse Merkle tree - host side.

Reference: ``reference/src/gadget_osmt.rs`` (marked incomplete in the
reference, ``lib.rs:20``): ethresear.ch-style compression where a subtree
containing a single key is stored as a ``(leaf=True, key, value)`` shortcut
node (:23-25); recursive update :158-236, get/verify_proof :71-156.  The
circuit gadget is ``unimplemented!()`` in the reference (:271-283); we mirror
that with :class:`NotImplementedError` for API parity.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.scalar import Scalar
from ..gadgets.scalar_utils import ScalarBits
from ..gadgets.poseidon import PoseidonParams, Poseidon_hash_2, SboxType


@dataclass
class OSMTNode:
    """DB value: shortcut leaf (is_leaf, key, value) or inner (left, right)."""

    is_leaf: bool
    a: Scalar  # key or left child hash
    b: Scalar  # value or right child hash


class OptimizedSparseMerkleTree:
    def __init__(self, hash_params: PoseidonParams, depth: int):
        self.depth = depth
        self.hash_params = hash_params
        self.db: dict[bytes, OSMTNode] = {}
        # empty_tree_hashes[i] = hash of an empty subtree whose *root* is at
        # level i (0 = tree root); reference builds it by repeated insert(0, .)
        empty = [Scalar.zero()]
        for _ in range(depth):
            prev = empty[0]
            empty.insert(
                0, Poseidon_hash_2(prev, prev, hash_params, SboxType.Inverse)
            )
        self.empty_tree_hashes = empty
        self.root = empty[0]

    def _hash2(self, l: Scalar, r: Scalar) -> Scalar:
        return Poseidon_hash_2(l, r, self.hash_params, SboxType.Inverse)

    def update(self, idx: Scalar, val: Scalar) -> Scalar:
        path = ScalarBits.from_scalar(idx, self.depth)
        self.root = self._update(path, val, self.root, 0)
        return self.root

    def get(self, idx: Scalar, proof: list[OSMTNode] | None = None) -> Scalar:
        cur_idx = ScalarBits.from_scalar(idx, self.depth)
        cur_node = self.root
        for i in range(self.depth):
            if cur_node == self.empty_tree_hashes[i]:
                return Scalar.zero()
            v = self.db[cur_node.to_bytes()]
            if proof is not None:
                proof.append(v)
            if v.is_leaf:
                if cur_idx.to_scalar() == v.a:
                    return v.b
                return Scalar.zero()
            cur_node = v.b if cur_idx.is_msb_set() else v.a
            cur_idx.shl()
        return cur_node

    def verify_proof(
        self, idx: Scalar, val: Scalar, proof: list[OSMTNode], root: Scalar
    ) -> bool:
        if root == self.empty_tree_hashes[0]:
            return len(proof) == 0
        prev_hash = root
        path = ScalarBits.from_scalar(idx, self.depth)
        for node in proof:
            if node.is_leaf:
                if node.a == path.to_scalar():
                    return node.b == val
                return val == Scalar.zero()
            expected = self._hash2(node.a, node.b)
            if expected != prev_hash:
                return False
            prev_hash = node.b if path.is_msb_set() else node.a
            path.shl()
        if len(proof) == self.depth:
            return prev_hash == val
        return val == Scalar.zero()

    # --- internals ----------------------------------------------------------
    def _update(
        self, path: ScalarBits, val: Scalar, root: Scalar, depth: int
    ) -> Scalar:
        if depth == self.depth:
            return val
        if root == self.empty_tree_hashes[depth]:
            new_root = self._subtree_with_one_val(path, val, depth)
            self.db[new_root.to_bytes()] = OSMTNode(True, path.to_scalar(), val)
            return new_root
        child = self.db[root.to_bytes()]
        if child.is_leaf:
            return self._update_one_val_subtree(
                path, val, ScalarBits.from_scalar(child.a, self.depth), child.b, depth
            )
        new_path = ScalarBits(list(path.bit_array))
        new_path.shl()
        if path.is_msb_set():
            new_right = self._update(new_path, val, child.b, depth + 1)
            new_root = self._hash2(child.a, new_right)
            self.db[new_root.to_bytes()] = OSMTNode(False, child.a, new_right)
        else:
            new_left = self._update(new_path, val, child.a, depth + 1)
            new_root = self._hash2(new_left, child.b)
            self.db[new_root.to_bytes()] = OSMTNode(False, new_left, child.b)
        return new_root

    def _update_one_val_subtree(
        self,
        path_new: ScalarBits,
        val_new: Scalar,
        path_old: ScalarBits,
        val_old: Scalar,
        depth: int,
    ) -> Scalar:
        if depth == self.depth:
            raise ValueError("key collision in update_one_val_subtree")
        next_new = ScalarBits(list(path_new.bit_array))
        next_new.shl()
        next_old = ScalarBits(list(path_old.bit_array))
        next_old.shl()
        if path_new.is_msb_set():
            if path_old.is_msb_set():
                left = self.empty_tree_hashes[depth + 1]
                right = self._update_one_val_subtree(
                    next_new, val_new, next_old, val_old, depth + 1
                )
            else:
                left = self._subtree_with_one_val(next_old, val_old, depth + 1)
                right = self._subtree_with_one_val(next_new, val_new, depth + 1)
                self.db[left.to_bytes()] = OSMTNode(
                    True, next_old.to_scalar(), val_old
                )
                self.db[right.to_bytes()] = OSMTNode(
                    True, next_new.to_scalar(), val_new
                )
        else:
            if path_old.is_msb_set():
                left = self._subtree_with_one_val(next_new, val_new, depth + 1)
                right = self._subtree_with_one_val(next_old, val_old, depth + 1)
                self.db[left.to_bytes()] = OSMTNode(
                    True, next_new.to_scalar(), val_new
                )
                self.db[right.to_bytes()] = OSMTNode(
                    True, next_old.to_scalar(), val_old
                )
            else:
                left = self._update_one_val_subtree(
                    next_new, val_new, next_old, val_old, depth + 1
                )
                right = self.empty_tree_hashes[depth + 1]
        root = self._hash2(left, right)
        self.db[root.to_bytes()] = OSMTNode(False, left, right)
        return root

    def _subtree_with_one_val(
        self, path: ScalarBits, val: Scalar, depth: int
    ) -> Scalar:
        if depth == self.depth:
            return val
        new_path = ScalarBits(list(path.bit_array))
        new_path.shl()
        if path.is_msb_set():
            l = self.empty_tree_hashes[depth + 1]
            r = self._subtree_with_one_val(new_path, val, depth + 1)
        else:
            l = self._subtree_with_one_val(new_path, val, depth + 1)
            r = self.empty_tree_hashes[depth + 1]
        return self._hash2(l, r)


def optimized_sparse_merkle_tree_verif_gadget(*args, **kwargs):
    """Circuit gadget left unimplemented, matching the reference
    (``gadget_osmt.rs:271-283``): a variable-length proof would leak the
    leaf's position in the compressed tree."""
    raise NotImplementedError(
        "OSMT circuit gadget is unimplemented (parity with reference)"
    )
