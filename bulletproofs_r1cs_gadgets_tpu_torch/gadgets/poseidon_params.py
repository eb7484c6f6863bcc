"""Poseidon parameters: width-6 permutation over the ristretto scalar field.

Reference: ``reference/src/gadget_poseidon.rs:27-94`` loads 960 hex
round keys and a 6x6 MDS matrix from hard-coded constants
(``poseidon_constants.rs``), both generated by the SageMath notebook
``Poseidon_Ristretto.ipynb`` (SURVEY.md S2a #13/#18):

* MDS: Cauchy matrix M[i][j] = (x_i + y_j)^-1 with x = 0..5, y = 6..11
  (notebook cell 4) - regenerated here and asserted against the data file.
* Round constants: Grain-LFSR bit stream with rejection sampling < L
  (notebook cells 8-11), reimplemented below (:func:`grain_round_constants`).
  The shipped 960 constants are the SECOND batch of 960 from a continuously
  running generator: the notebook's constants cell was executed twice
  without re-running the generator-init cell, so the saved output starts at
  stream index 960.  :func:`reference_round_constants` reproduces the
  shipped data exactly (asserted in tests/test_hashes.py).

NOTE on endianness: constants are loaded through the reference's
``get_scalar_from_hex`` (``scalar_utils.rs:232-237``) which feeds the decoded
big-endian-looking bytes to the little-endian ``from_bytes_mod_order`` - the
effective runtime constants are the byte-reversed hex values.  We reproduce
this exactly for circuit parity.
"""

from __future__ import annotations

import json
import os

from ..core.scalar import Scalar
from ..utils.constants import L
from .scalar_utils import get_scalar_from_hex

_DATA_FILE = os.path.join(os.path.dirname(__file__), "poseidon_constants.json")


def _load_data():
    with open(_DATA_FILE) as f:
        return json.load(f)


def cauchy_mds_matrix(width: int, start: int = 0) -> list[list[int]]:
    """Notebook cell 4: M[i][j] = (x_i + y_j)^-1 mod L with
    x_i = start+i, y_j = start+width+j."""
    return [
        [pow(start + i + width + start + j, L - 2, L) for j in range(width)]
        for i in range(width)
    ]


def grain_round_constants(num: int, field_bits: int = 253) -> list[int]:
    """Notebook cells 8-11: Grain-LFSR round-constant stream.

    80-bit all-ones state, taps {62, 51, 38, 23, 13, 0}, 160 warm-up steps,
    then pair-decoded output bits with rejection sampling >= L.
    """
    bs = [1] * 80

    def step() -> int:
        nb = bs[62] ^ bs[51] ^ bs[38] ^ bs[23] ^ bs[13] ^ bs[0]
        bs.pop(0)
        bs.append(nb)
        return nb

    for _ in range(160):
        step()

    def out_bit() -> int:
        nb = step()
        while nb == 0:
            step()
            nb = step()
        return step()

    def rand_int() -> int:
        v = 0
        for _ in range(field_bits):
            v = (v << 1) | out_bit()
        return v

    consts = []
    while len(consts) < num:
        r = rand_int()
        if r < L:
            consts.append(r)
    return consts


def reference_round_constants() -> list[int]:
    """The exact 960 shipped constants (``poseidon_constants.rs:10``),
    re-derived from the Grain stream: the notebook's constants cell ran
    twice against one generator instance, so the shipped data is the
    second 960-constant batch (stream indices 960..1919)."""
    return grain_round_constants(1920)[960:]


class PoseidonParams:
    """Poseidon permutation parameters (``gadget_poseidon.rs:27-94``)."""

    def __init__(
        self,
        width: int,
        full_rounds_beginning: int,
        full_rounds_end: int,
        partial_rounds: int,
    ):
        total_rounds = full_rounds_beginning + partial_rounds + full_rounds_end
        self.width = width
        self.full_rounds_beginning = full_rounds_beginning
        self.full_rounds_end = full_rounds_end
        self.partial_rounds = partial_rounds
        self.round_keys = self._gen_round_keys(width, total_rounds)
        self.MDS_matrix = self._gen_mds_matrix(width)

    @staticmethod
    def _gen_round_keys(width: int, total_rounds: int) -> list[Scalar]:
        data = _load_data()
        cap = total_rounds * width
        rc_hex = data["round_consts_hex"]
        if len(rc_hex) < cap:
            raise ValueError(
                f"Not enough round constants, need {cap}, found {len(rc_hex)}"
            )
        return [get_scalar_from_hex(h) for h in rc_hex[:cap]]

    @staticmethod
    def _gen_mds_matrix(width: int) -> list[list[Scalar]]:
        data = _load_data()
        mds_hex = data["mds_hex"]
        if len(mds_hex) != width:
            raise ValueError(f"only width {len(mds_hex)} is supported")
        # data-file MDS must agree with the Cauchy construction
        cauchy = cauchy_mds_matrix(width)
        for i in range(width):
            for j in range(width):
                assert int(mds_hex[i][j], 16) == cauchy[i][j], "MDS data corrupt"
        return [[get_scalar_from_hex(h) for h in row] for row in mds_hex]

    def get_total_rounds(self) -> int:
        return self.full_rounds_beginning + self.partial_rounds + self.full_rounds_end
