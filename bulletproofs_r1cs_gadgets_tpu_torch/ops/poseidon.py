"""Batched Poseidon permutation on the device (the JAX package's
``ops/poseidon.py``).

The native/circuit Poseidon pair lives in ``gadgets/poseidon.py`` (host,
reference-exact); this module is the throughput path: many independent
permutations per call (bulk sparse-Merkle-tree node hashing, batched
witness generation).

State is ``(batch, width, 8)`` FQ words (:class:`.field.LimbField`).  Each
round adds its keys (plain torch mod l), applies the S-box (the cube: two
``mul_fq`` launches; the inverse: a Fermat power, one launch per square
and per set bit) to every lane in a full round and to the last lane in a
partial round, and mixes with the MDS matrix: one ``mul_fq`` launch over
``(batch, width, width)`` and a plain mod-l sum.  A Python loop over the
rounds takes the place of the JAX package's ``lax.scan``.
"""

from __future__ import annotations

import torch

from ..gadgets.poseidon_params import PoseidonParams
from .field import FQ, ints_to_words


class DevicePoseidon:
    """Batched permutation for fixed parameters on `device` (the card by
    default)."""

    def __init__(self, params: PoseidonParams, sbox: str = "inverse",
                 device="cuda"):
        assert sbox in ("cube", "inverse")
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
        self._full = [True] * fb + [False] * pr + [True] * fe

    def _sbox_apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.sbox == "cube":
            return FQ.mul(FQ.square(x), x)
        return FQ.inv(x)

    def permute(self, state: torch.Tensor) -> torch.Tensor:
        """(batch, width, 8) -> same, one full permutation."""
        st = state
        for keys, full in zip(self._round_keys, self._full):
            st = FQ.add(st, keys)
            if full:
                st = self._sbox_apply(st)
            else:  # partial round: the S-box on the last lane only
                st = torch.cat([st[:, :-1], self._sbox_apply(st[:, -1:])], dim=1)
            # MDS: st'[i] = sum_j M[i][j] * st[j]
            st = FQ.sum(FQ.mul(self._mds[None], st[:, None]), dim=-2)
        return st

    def _pad(self, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        zero = FQ.zeros((b, 1), self.device)
        pad = FQ.constant(101, self.device).expand(b, 1, 8)
        return zero, pad

    # the batched 2:1 hash (input layout of gadget_poseidon.rs:428)
    def hash_2(self, xl: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
        """xl, xr: (batch, 8) -> (batch, 8)."""
        zero, pad = self._pad(xl.shape[0])
        state = torch.cat([zero, xl[:, None], xr[:, None], pad, zero, zero],
                          dim=1)
        return self.permute(state)[:, 1]

    def hash_4(self, x: torch.Tensor) -> torch.Tensor:
        """x: (batch, 4, 8) -> (batch, 8)."""
        zero, pad = self._pad(x.shape[0])
        return self.permute(torch.cat([zero, x, pad], dim=1))[:, 1]
