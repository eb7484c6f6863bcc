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
  rows (``core/scvec`` layout);
* :func:`capacity_points` and :func:`capacity_words` take the TPU
  kernels' capacity layouts (``ops/chunks.py`` there: chunks of 2048
  points, chunk c at lanes [256c, 256(c + 1)) of a ``(rows, 8, lanes)``
  array, its point f at sublane f // 256, lane f % 256) and give the
  port's flat tensors in the order of the points the chunks were made
  from; points and words go through the same permutation, so each point
  keeps its word;
* :func:`field_words` takes the JAX package's field elements, ``(..., 23)``
  balanced 12-bit limbs (``FQ`` / ``FP.to_device`` there, or any lazy
  result), and gives the port's ``(..., 8)`` words mod l or mod p;
  :func:`stacked_field` takes the Pallas field kernels' limb-major
  ``(23, 8, lanes)`` stacks (``pallas_field.to_limb_major``);
* :func:`stacked_points` takes the stacked point blocks ``(92, 8, lanes)``
  of ``pallas_curve.points_to_rows`` (point j at flat lattice position j,
  any lane count; one 2048-point chunk at 256 lanes) or the emitters'
  tuple of four ``(23, 8, lanes)`` coordinate stacks, and
  :func:`stacked_words` their ``(8, 8, lanes)`` word stacks
  (``pallas_curve.words_to_rows``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import scvec
from .core.pedersen import BulletproofGens
from .gadgets.poseidon_params import PoseidonParams
from .ops import field as F
from .utils.constants import L, P

_SUB, _LANES = 8, 256  # a chunk's sublanes and lanes


def _unchunk(arr: np.ndarray) -> np.ndarray:
    """(rows, 8, k * 256) capacity array -> (k * 2048, rows), row c * 2048
    + s * 256 + l from chunk c, sublane s, lane l."""
    rows, sub, lanes = arr.shape
    if sub != _SUB or lanes % _LANES:
        raise ValueError(f"not a capacity array: shape {arr.shape}")
    k = lanes // _LANES
    cols = arr.reshape(rows, _SUB, k, _LANES).transpose(2, 1, 3, 0)
    return cols.reshape(k * _SUB * _LANES, rows)


def capacity_points(big, device="cpu") -> torch.Tensor:
    """The JAX package's stacked-limb point array ``(92, 8, lanes)`` int32
    (4 coordinates x 23 balanced 12-bit limbs; ``chunks.points_to_chunks``
    concatenated on the lane axis) -> ``(n, 4, 8)`` canonical words."""
    a = np.asarray(big)
    if a.shape[0] != 4 * F.JAX_STORE:
        raise ValueError(f"expected {4 * F.JAX_STORE} limb rows, got {a.shape}")
    flat = _unchunk(a)
    return F.from_jax_limbs(flat.reshape(-1, 4, F.JAX_STORE), device)


def capacity_words(words, device="cpu") -> torch.Tensor:
    """The JAX package's packed w4 word array ``(8, 8, lanes)`` int32
    (``chunks.words_chunks(..., encode="w4")`` concatenated on the lane
    axis) -> ``(n, 8)`` int32 word rows (the port's w4 words)."""
    a = np.asarray(words, dtype=np.int32)
    if a.shape[0] != 8:
        raise ValueError(f"expected 8 word rows, got {a.shape}")
    return torch.from_numpy(np.ascontiguousarray(_unchunk(a))).to(device)


def field_words(limbs, modulus: int, device="cpu") -> torch.Tensor:
    """(..., 23) balanced 12-bit limbs (the JAX package's ``LimbField``
    layout, lazy values allowed) -> (..., 8) int32 words of each value mod
    `modulus` (``L`` for ``FQ``, ``P`` for ``FP``)."""
    if modulus not in (L, P):
        raise ValueError("modulus: L (FQ) or P (FP)")
    a = np.asarray(limbs)
    if a.shape[-1] != F.JAX_STORE:
        raise ValueError(f"expected {F.JAX_STORE} limbs, got {a.shape}")
    vals = [
        sum(int(v) << (F.JAX_LIMB_BITS * i) for i, v in enumerate(row))
        % modulus
        for row in a.reshape(-1, F.JAX_STORE).tolist()
    ]
    w = F.ints_to_words(vals).reshape(a.shape[:-1] + (8,))
    return torch.from_numpy(w.copy()).to(device)


def stacked_field(arr, modulus: int, device="cpu") -> torch.Tensor:
    """Limb-major (23, 8, lanes) field stack -> (8 * lanes, 8) words."""
    a = np.asarray(arr)
    return field_words(a.reshape(a.shape[0], -1).T, modulus, device)


def stacked_points(block, device="cpu") -> torch.Tensor:
    """(92, 8, lanes) stacked points, or a tuple of four (23, 8, lanes)
    coordinate stacks, -> (8 * lanes, 4, 8) canonical words, point j from
    flat lattice position j (``F.from_jax_chunk`` for any lane count)."""
    if isinstance(block, (tuple, list)):
        block = np.concatenate([np.asarray(c) for c in block], axis=0)
    a = np.asarray(block)
    if a.shape[0] != 4 * F.JAX_STORE:
        raise ValueError(f"expected {4 * F.JAX_STORE} limb rows, got {a.shape}")
    return F.from_jax_chunk(a, device)


def stacked_words(words, device="cpu") -> torch.Tensor:
    """(8, 8, lanes) word stack -> (8 * lanes, 8) int32 word rows."""
    a = np.asarray(words, dtype=np.int32)
    return torch.from_numpy(np.ascontiguousarray(a.reshape(8, -1).T)).to(device)


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
