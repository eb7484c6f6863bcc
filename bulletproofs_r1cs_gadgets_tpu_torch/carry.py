"""State carried across from the JAX package, as the port's objects.

The two packages hold the same parameters in the same numpy layouts; this
module rebuilds the port's objects from those arrays without deriving
anything again, so a test (or a process that received the arrays) can
feed both packages the same state:

* :func:`bulletproof_gens_from_arrays` takes the ``(n, 4, 16)`` uint16
  coordinate arrays of ``BulletproofGens.G_raw`` / ``H_raw`` (one per
  party, or a list of them);
* :func:`poseidon_params_from_arrays` takes a Poseidon width, its round
  counts, and the round keys and MDS matrix as ``(m, 4)`` uint64 scalar
  rows (``core/scvec`` layout).
"""

from __future__ import annotations

import numpy as np

from .core import scvec
from .core.pedersen import BulletproofGens
from .gadgets.poseidon_params import PoseidonParams


def _party_arrays(arrs) -> list[np.ndarray]:
    if isinstance(arrs, np.ndarray):
        arrs = [arrs]
    out = []
    for a in arrs:
        a = np.ascontiguousarray(a, dtype=np.uint16)
        if a.ndim != 3 or a.shape[1:] != (4, 16):
            raise ValueError(f"expected (n, 4, 16) uint16, got {a.shape}")
        out.append(a)
    return out


def bulletproof_gens_from_arrays(G_arr, H_arr) -> BulletproofGens:
    """A port ``BulletproofGens`` holding exactly these generator arrays
    (capacity n = their length; one party per array)."""
    G, H = _party_arrays(G_arr), _party_arrays(H_arr)
    if len(G) != len(H) or any(g.shape != h.shape for g, h in zip(G, H)):
        raise ValueError("G and H arrays differ in party count or shape")
    caps = {g.shape[0] for g in G}
    if len(caps) != 1:
        raise ValueError("parties of different capacities")
    gens = BulletproofGens.__new__(BulletproofGens)
    gens.gens_capacity = caps.pop()
    gens.party_capacity = len(G)
    gens.G_arr = G
    gens.H_arr = H
    gens._obj_cache = {}
    gens._limb_cache = {}
    return gens


def poseidon_params_from_arrays(
    width: int, full_rounds_beginning: int, full_rounds_end: int,
    partial_rounds: int, round_keys: np.ndarray, mds: np.ndarray,
) -> PoseidonParams:
    """A port ``PoseidonParams`` with these round keys ((R * width, 4)
    u64 rows) and MDS matrix ((width * width, 4) or (width, width, 4)
    u64 rows, row-major)."""
    total = full_rounds_beginning + partial_rounds + full_rounds_end
    rk = np.asarray(round_keys, dtype=np.uint64)
    m = np.asarray(mds, dtype=np.uint64).reshape(-1, 4)
    if rk.shape != (total * width, 4):
        raise ValueError(f"round keys {rk.shape}, expected {(total * width, 4)}")
    if m.shape != (width * width, 4):
        raise ValueError(f"MDS {m.shape}, expected {(width * width, 4)}")
    params = PoseidonParams.__new__(PoseidonParams)
    params.width = width
    params.full_rounds_beginning = full_rounds_beginning
    params.full_rounds_end = full_rounds_end
    params.partial_rounds = partial_rounds
    params.round_keys = scvec.to_scalars(rk)
    flat = scvec.to_scalars(m)
    params.MDS_matrix = [flat[i * width : (i + 1) * width] for i in range(width)]
    return params
