"""Pedersen commitment & Bulletproof generator chains.

Mirrors the dalek-bulletproofs generator derivation the reference depends on
(SURVEY.md S2b N3/N4):

* ``PedersenGens``: B = ristretto basepoint; B_blinding = SHA3-512
  hash-to-group of B's compressed encoding.  Used at every test site, e.g.
  ``reference/src/factors.rs:52``.
* ``BulletproofGens(gens_capacity, party_capacity)``: per-party G/H vectors
  from SHAKE-256 XOF chains labelled ``b'G' || LE32(party)`` /
  ``b'H' || LE32(party)``.  The reference always passes ``party_capacity=1``
  and capacities 128 / 2048 / 819200 (``gadget_vsmt_2.rs:290``).

Deriving 819200 generators needs ~1.6M Elligator maps; the batched TPU path
(:func:`bulletproofs_r1cs_gadgets_tpu.ops.curve.from_uniform_bytes_batch`) is
used when available and results are cached on disk as numpy arrays of the
extended Edwards coordinates.
"""

from __future__ import annotations

import hashlib
import os
import numpy as np

from .ristretto import RistrettoPoint, FixedBaseTable
from .scalar import Scalar

_CACHE_DIR = os.environ.get(
    "BPTPU_GENS_CACHE", os.path.join(os.path.dirname(__file__), "..", "..", ".gens_cache")
)


class PedersenGens:
    """Bases for Pedersen commitments: commit(v, b) = v*B + b*B_blinding."""

    def __init__(self):
        self.B = RistrettoPoint.basepoint()
        self.B_blinding = RistrettoPoint.hash_from_bytes_sha3_512(
            self.B.compress()
        )
        self._tables = None

    @staticmethod
    def default() -> "PedersenGens":
        return _DEFAULT_PC_GENS

    def commit(self, value: Scalar, blinding: Scalar) -> RistrettoPoint:
        if self._tables is None:
            # built on first commit (~0.1 s), then every commit is ~64
            # table additions instead of two full ladders
            self._tables = (
                FixedBaseTable(self.B), FixedBaseTable(self.B_blinding)
            )
        tB, tBb = self._tables
        return tB.mul(value) + tBb.mul(blinding)


class GeneratorsChain:
    """SHAKE-256 XOF chain of ristretto points (dalek's GeneratorsChain)."""

    def __init__(self, label: bytes):
        shake = hashlib.shake_256()
        shake.update(b"GeneratorsChain")
        shake.update(label)
        self._shake = shake
        self._offset = 0

    def take(self, n: int) -> list[RistrettoPoint]:
        total = self._offset + 64 * n
        stream = self._shake.digest(total)
        out = []
        for i in range(n):
            chunk = stream[self._offset + 64 * i : self._offset + 64 * (i + 1)]
            out.append(RistrettoPoint.from_uniform_bytes(chunk))
        self._offset = total
        return out

    def uniform_bytes(self, n: int) -> list[bytes]:
        """The raw 64-byte seeds, for batched on-device mapping."""
        total = self._offset + 64 * n
        stream = self._shake.digest(total)
        out = [
            stream[self._offset + 64 * i : self._offset + 64 * (i + 1)]
            for i in range(n)
        ]
        self._offset = total
        return out


def _chain_label(prefix: bytes, party: int) -> bytes:
    return prefix + int(party).to_bytes(4, "little")


def _derive_chain(label: bytes, n: int) -> np.ndarray:
    """Derive n chain points as a (n, 4, 16) uint16 coordinate array,
    preferring the batched device path + disk cache.  Python point objects
    are materialized lazily by the callers that need them."""
    # v2: cache invalidated when SQRT_AD_MINUS_ONE switched to dalek's odd
    # root (every Elligator-derived point changed; see utils/constants.py)
    key = f"{label.hex()}_{n}"
    cache_file = os.path.join(_CACHE_DIR, f"gens_v2_{key}.npy")
    if os.path.exists(cache_file):
        return np.load(cache_file, allow_pickle=False)
    # a larger cached chain for the same label is a superset (XOF prefix):
    # slice it instead of re-deriving
    try:
        prefix = f"gens_v2_{label.hex()}_"
        for fname in os.listdir(_CACHE_DIR):
            if fname.startswith(prefix) and fname.endswith(".npy"):
                m = int(fname[len(prefix) : -4])
                if m >= n:
                    arr = np.load(
                        os.path.join(_CACHE_DIR, fname), allow_pickle=False
                    )
                    return arr[:n]
    except (OSError, ValueError):
        pass
    chain = GeneratorsChain(label)
    arr = None
    if n > 256:
        # C++ Elligator batch (~30 us/point, threaded): deriving 2 x 2^18
        # chain points costs seconds instead of ~13 Python minutes
        try:
            from ..native.loader import load_native

            native = load_native()
            if native is not None:
                seeds = b"".join(chain.uniform_bytes(n))
                raw = native.ge_from_uniform_batch(seeds)
                arr = np.frombuffer(raw, dtype="<u2").reshape(n, 4, 16).copy()
        except Exception:
            arr = None
    if arr is None:
        arr = _points_to_array(chain.take(n))
    try:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        np.save(cache_file, arr)
    except OSError:
        pass
    return arr


def _points_to_array(pts: list[RistrettoPoint]) -> np.ndarray:
    out = np.zeros((len(pts), 4, 16), dtype=np.uint16)
    for i, pt in enumerate(pts):
        for j, c in enumerate((pt.X, pt.Y, pt.Z, pt.T)):
            for k in range(16):
                out[i, j, k] = (c >> (16 * k)) & 0xFFFF
    return out


def _points_from_array(arr: np.ndarray) -> list[RistrettoPoint]:
    # bulk bytes -> per-coordinate ints (the per-limb Python loop was ~10x
    # slower); objects are only built for host-path consumers
    n = arr.shape[0]
    buf = np.ascontiguousarray(arr, dtype="<u2").tobytes()
    out = []
    for i in range(n):
        base = 128 * i
        out.append(
            RistrettoPoint(
                int.from_bytes(buf[base : base + 32], "little"),
                int.from_bytes(buf[base + 32 : base + 64], "little"),
                int.from_bytes(buf[base + 64 : base + 96], "little"),
                int.from_bytes(buf[base + 96 : base + 128], "little"),
            )
        )
    return out


def _u16_to_limbs_i32(arr: np.ndarray) -> np.ndarray:
    """(n, 4, 16) u16 coordinate array -> (n, 4, 23) int32 12-bit limbs
    (the TPU kernels' field layout), fully vectorized."""
    n = arr.shape[0]
    b = np.ascontiguousarray(arr, dtype="<u2").view(np.uint8)  # (n, 4, 32)
    w = np.concatenate(
        [b, np.zeros((n, 4, 4), dtype=np.uint8)], axis=-1
    ).astype(np.int32)
    out = np.empty((n, 4, 23), dtype=np.int32)
    for i in range(23):
        bit = 12 * i
        byte, r = divmod(bit, 8)
        val = w[..., byte] | (w[..., byte + 1] << 8) | (w[..., byte + 2] << 16)
        out[..., i] = (val >> r) & 0xFFF
    return out


class BulletproofGens:
    """Generator vectors for the R1CS/IPP engine (dalek layout).

    Coordinates are held as (n, 4, 16) uint16 numpy arrays; Python point
    objects (host MSM paths) and TPU limb arrays (device upload paths) are
    materialized lazily and memoized.
    """

    def __init__(self, gens_capacity: int, party_capacity: int = 1):
        self.gens_capacity = gens_capacity
        self.party_capacity = party_capacity
        self.G_arr: list[np.ndarray] = []
        self.H_arr: list[np.ndarray] = []
        for j in range(party_capacity):
            self.G_arr.append(_derive_chain(_chain_label(b"G", j), gens_capacity))
            self.H_arr.append(_derive_chain(_chain_label(b"H", j), gens_capacity))
        self._obj_cache: dict = {}
        self._limb_cache: dict = {}

    def _objs(self, which: str, party: int) -> list[RistrettoPoint]:
        key = (which, party)
        hit = self._obj_cache.get(key)
        if hit is None:
            arr = (self.G_arr if which == "G" else self.H_arr)[party]
            hit = _points_from_array(arr)
            self._obj_cache[key] = hit
        return hit

    def G(self, n: int, party: int = 0) -> list[RistrettoPoint]:
        return self._objs("G", party)[:n]

    def H(self, n: int, party: int = 0) -> list[RistrettoPoint]:
        return self._objs("H", party)[:n]

    def G_raw(self, n: int, party: int = 0) -> np.ndarray:
        """(n, 4, 16) uint16 raw extended-coordinate array (the storage
        layout; 128 B/point LE — the native group layer's input)."""
        return self.G_arr[party][:n]

    def H_raw(self, n: int, party: int = 0) -> np.ndarray:
        return self.H_arr[party][:n]

    def G_limbs(self, n: int, party: int = 0) -> np.ndarray:
        """(n, 4, 23) int32 12-bit-limb array (device-upload layout)."""
        key = ("G", party)
        hit = self._limb_cache.get(key)
        if hit is None:
            hit = _u16_to_limbs_i32(self.G_arr[party])
            self._limb_cache[key] = hit
        return hit[:n]

    def H_limbs(self, n: int, party: int = 0) -> np.ndarray:
        key = ("H", party)
        hit = self._limb_cache.get(key)
        if hit is None:
            hit = _u16_to_limbs_i32(self.H_arr[party])
            self._limb_cache[key] = hit
        return hit[:n]

    def share(self, party: int):
        return _BulletproofGensShare(self, party)


class _BulletproofGensShare:
    def __init__(self, gens: BulletproofGens, share: int):
        self._gens = gens
        self._share = share

    def G(self, n: int):
        return self._gens.G(n, self._share)

    def H(self, n: int):
        return self._gens.H(n, self._share)

    def G_limbs(self, n: int):
        return self._gens.G_limbs(n, self._share)

    def H_limbs(self, n: int):
        return self._gens.H_limbs(n, self._share)

    def G_raw(self, n: int):
        return self._gens.G_raw(n, self._share)

    def H_raw(self, n: int):
        return self._gens.H_raw(n, self._share)


_DEFAULT_PC_GENS = PedersenGens()
