"""Batched Poseidon permutation on the device (the JAX package's
``ops/poseidon.py``).

The native/circuit Poseidon pair lives in ``gadgets/poseidon.py`` (host,
reference-exact); this module is the throughput path: many independent
permutations per call (bulk sparse-Merkle-tree node hashing, batched
witness generation).

State is ``(batch, width, 8)`` FQ words (:class:`.field.LimbField`),
canonical mod l.  Each round adds its keys, applies the S-box (the cube or
the inverse, a Fermat power) to every lane in a full round and to the last
lane in a partial round, and mixes with the MDS matrix.  Where the JAX
package compiles the rounds' ``lax.scan`` into one XLA program, the port
runs them in one kernel launch: ``permute`` (and ``hash_2`` / ``hash_4``)
launch ``poseidon_permute``, and ``chain`` (a Merkle path's fold of 2:1
hashes) launches ``poseidon_chain`` once for all its hashes
(``csrc/poseidon.cu``, ``ops/cuda_curve.py``).  A CPU state runs the
kernels' plain versions.  Widths 2 to 8 (the chain 4 to 8).
"""

from __future__ import annotations

import torch

from ..gadgets.poseidon_params import PoseidonParams
from . import cuda_curve as cc
from .field import ints_to_words

PAD = 101  # the hash's padding lane (gadget_poseidon.rs:428)


def hash_state(lanes: torch.Tensor, width: int) -> torch.Tensor:
    """(B, width, 8): the k:1 hash's input state [0, x_1 .. x_k, 101, 0, ...]
    for lanes (B, k, 8), k + 2 <= width (gadget_poseidon.rs:428 at k = 2;
    ``csrc/poseidon.cu``'s chain builds the same state for k = 2)."""
    b, k = lanes.shape[:2]
    state = torch.zeros((b, width, 8), dtype=torch.int32, device=lanes.device)
    state[:, 1 : k + 1] = lanes
    state[:, k + 1, 0] = PAD
    return state


class DevicePoseidon:
    """Batched permutation for fixed parameters on `device` (the card by
    default)."""

    def __init__(self, params: PoseidonParams, sbox: str = "inverse",
                 device="cuda"):
        assert sbox in cc.POSEIDON_SBOXES
        self.params = params
        self.sbox = sbox
        self.width = params.width
        self.device = torch.device(device)
        w = self.width
        total = params.get_total_rounds()
        rk = ints_to_words([params.round_keys[i].v for i in range(total * w)])
        self._round_keys = torch.from_numpy(
            rk.reshape(total, w, 8).copy()).to(self.device)
        mds = ints_to_words(
            [params.MDS_matrix[i][j].v for i in range(w) for j in range(w)]
        )
        self._mds = torch.from_numpy(mds.reshape(w, w, 8).copy()).to(self.device)
        fb, pr, fe = (params.full_rounds_beginning, params.partial_rounds,
                      params.full_rounds_end)
        self._full_mask = torch.tensor([1] * fb + [0] * pr + [1] * fe,
                                       dtype=torch.int32, device=self.device)

    def _consts(self) -> tuple:
        return self._round_keys, self._mds, self._full_mask, self.sbox

    def permute(self, state: torch.Tensor) -> torch.Tensor:
        """(batch, width, 8) -> same, one full permutation.  The state must
        be canonical words mod l (unchecked: the kernel relies on it)."""
        return cc.poseidon_permute(state.contiguous(), *self._consts())

    # the batched 2:1 hash (input layout of gadget_poseidon.rs:428)
    def hash_2(self, xl: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
        """xl, xr: (batch, 8) -> (batch, 8)."""
        return self.permute(hash_state(torch.stack([xl, xr], dim=1),
                                       self.width))[:, 1]

    def hash_4(self, x: torch.Tensor) -> torch.Tensor:
        """x: (batch, 4, 8) -> (batch, 8)."""
        return self.permute(hash_state(x, self.width))[:, 1]

    def chain(self, witness: torch.Tensor) -> torch.Tensor:
        """(batch, W, 8) -> (batch, 8): acc <- hash_2(acc, witness[:, i])
        for i = 1..W-1 from acc = witness[:, 0], in one launch.  The
        witness must be canonical words mod l (unchecked)."""
        return cc.poseidon_chain(witness.contiguous(), *self._consts())
