"""Ristretto255 group (host side): Edwards points, compress/decompress,
Elligator map, hash-to-group, scalar multiplication and a Pippenger MSM.

Covers the ``RistrettoPoint`` / ``CompressedRistretto`` surface the reference
stack uses (SURVEY.md S2b N2): Pedersen commitments are compressed points
(e.g. ``reference/src/gadget_poseidon.rs:584-587``), generators come
from ``from_uniform_bytes`` (SHAKE-256 XOF) and ``hash_from_bytes::<Sha3_512>``.

Formulas follow RFC 9496 (ristretto255) and the extended-coordinate Edwards
addition laws (Hisil-Wong-Carter-Dawson 2008, as in curve25519-dalek).  The
hot batched/MSM path runs on TPU via :mod:`bulletproofs_r1cs_gadgets_tpu.ops.curve`;
this module is the exact host reference and handles small/latency-bound work.
"""

from __future__ import annotations

import hashlib

from ..utils.constants import (
    P,
    D,
    D2,
    SQRT_M1,
    INVSQRT_A_MINUS_D,
    ONE_MINUS_D_SQ,
    D_MINUS_ONE_SQ,
    SQRT_AD_MINUS_ONE,
    ED25519_BASEPOINT_X,
    ED25519_BASEPOINT_Y,
)
from .scalar import Scalar


def _is_negative(x: int) -> bool:
    return x & 1 == 1


class RistrettoPoint:
    """Edwards point in extended homogeneous coordinates (X:Y:Z:T)."""

    __slots__ = ("X", "Y", "Z", "T")

    def __init__(self, X: int, Y: int, Z: int, T: int):
        self.X, self.Y, self.Z, self.T = X % P, Y % P, Z % P, T % P

    # --- constants ---------------------------------------------------------
    @staticmethod
    def identity() -> "RistrettoPoint":
        return RistrettoPoint(0, 1, 1, 0)

    @staticmethod
    def basepoint() -> "RistrettoPoint":
        x, y = ED25519_BASEPOINT_X, ED25519_BASEPOINT_Y
        return RistrettoPoint(x, y, 1, x * y % P)

    # --- group law ---------------------------------------------------------
    def __add__(self, other: "RistrettoPoint") -> "RistrettoPoint":
        # add-2008-hwcd-3 (a = -1, unified)
        X1, Y1, Z1, T1 = self.X, self.Y, self.Z, self.T
        X2, Y2, Z2, T2 = other.X, other.Y, other.Z, other.T
        A = (Y1 - X1) * (Y2 - X2) % P
        B = (Y1 + X1) * (Y2 + X2) % P
        C = T1 * D2 % P * T2 % P
        Dv = 2 * Z1 * Z2 % P
        E = B - A
        F = Dv - C
        G = Dv + C
        H = B + A
        return RistrettoPoint(E * F, G * H, F * G, E * H)

    def double(self) -> "RistrettoPoint":
        # dbl-2008-hwcd (a = -1)
        X1, Y1, Z1 = self.X, self.Y, self.Z
        A = X1 * X1 % P
        B = Y1 * Y1 % P
        C = 2 * Z1 * Z1 % P
        H = A + B
        E = (H - (X1 + Y1) * (X1 + Y1)) % P
        G = A - B
        F = C + G
        return RistrettoPoint(E * F, G * H, F * G, E * H)

    def __neg__(self) -> "RistrettoPoint":
        return RistrettoPoint(P - self.X, self.Y, self.Z, P - self.T)

    def __sub__(self, other: "RistrettoPoint") -> "RistrettoPoint":
        return self + (-other)

    def scalar_mul(self, s: Scalar) -> "RistrettoPoint":
        """4-bit fixed-window scalar multiplication (host, variable time)."""
        k = s.v
        if k == 0:
            return RistrettoPoint.identity()
        table = [RistrettoPoint.identity(), self]
        for _ in range(14):
            table.append(table[-1] + self)
        acc = RistrettoPoint.identity()
        nibbles = []
        while k:
            nibbles.append(k & 15)
            k >>= 4
        for nib in reversed(nibbles):
            for _ in range(4):
                acc = acc.double()
            if nib:
                acc = acc + table[nib]
        return acc

    def __rmul__(self, s: Scalar) -> "RistrettoPoint":
        return self.scalar_mul(s)

    # --- ristretto encoding ------------------------------------------------
    def compress(self) -> bytes:
        X, Y, Z, T = self.X, self.Y, self.Z, self.T
        u1 = (Z + Y) * (Z - Y) % P
        u2 = X * Y % P
        _, invsqrt = _sqrt_ratio(1, u1 * u2 % P * u2 % P)
        den1 = invsqrt * u1 % P
        den2 = invsqrt * u2 % P
        z_inv = den1 * den2 % P * T % P
        ix = X * SQRT_M1 % P
        iy = Y * SQRT_M1 % P
        enchanted = den1 * INVSQRT_A_MINUS_D % P
        rotate = _is_negative(T * z_inv % P)
        if rotate:
            x, y, den_inv = iy, ix, enchanted
        else:
            x, y, den_inv = X, Y, den2
        if _is_negative(x * z_inv % P):
            y = P - y
        s = den_inv * ((Z - y) % P) % P
        if _is_negative(s):
            s = P - s
        return s.to_bytes(32, "little")

    @staticmethod
    def decompress(data: bytes) -> "RistrettoPoint":
        if len(data) != 32:
            raise ValueError("invalid length")
        s = int.from_bytes(data, "little")
        if s >= P or _is_negative(s):
            raise ValueError("non-canonical ristretto encoding")
        ss = s * s % P
        u1 = (1 - ss) % P
        u2 = (1 + ss) % P
        u2_sqr = u2 * u2 % P
        v = (-(D * u1 % P * u1) - u2_sqr) % P
        was_square, invsqrt = _sqrt_ratio(1, v * u2_sqr % P)
        den_x = invsqrt * u2 % P
        den_y = invsqrt * den_x % P * v % P
        x = 2 * s * den_x % P
        if _is_negative(x):
            x = P - x
        y = u1 * den_y % P
        t = x * y % P
        if (not was_square) or _is_negative(t) or y == 0:
            raise ValueError("invalid ristretto encoding")
        return RistrettoPoint(x, y, 1, t)

    # --- hashing to the group ----------------------------------------------
    @staticmethod
    def from_uniform_bytes(b: bytes) -> "RistrettoPoint":
        assert len(b) == 64
        r1 = int.from_bytes(b[0:32], "little") & ((1 << 255) - 1)
        r2 = int.from_bytes(b[32:64], "little") & ((1 << 255) - 1)
        return _elligator(r1 % P) + _elligator(r2 % P)

    @staticmethod
    def hash_from_bytes_sha3_512(data: bytes) -> "RistrettoPoint":
        return RistrettoPoint.from_uniform_bytes(hashlib.sha3_512(data).digest())

    # --- comparisons --------------------------------------------------------
    def __eq__(self, other) -> bool:
        # ristretto coset equality (dalek): X1Y2 == Y1X2 or X1X2 == Y1Y2
        if not isinstance(other, RistrettoPoint):
            return NotImplemented
        return (
            self.X * other.Y % P == self.Y * other.X % P
            or self.X * other.X % P == self.Y * other.Y % P
        )

    def is_identity(self) -> bool:
        # ristretto coset equality against (0, 1): X == 0 or Y == 0
        return self.X == 0 or self.Y == 0

    def __repr__(self) -> str:
        return f"RistrettoPoint({self.compress().hex()})"


def _sqrt_ratio(u: int, v: int) -> tuple[bool, int]:
    """(was_square, s) with s = non-negative sqrt(u/v) if square else
    sqrt(i*u/v)."""
    v3 = (v * v % P) * v % P
    v7 = (v3 * v3 % P) * v % P
    r = (u * v3 % P) * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * (r * r % P) % P
    u = u % P
    u_neg = (P - u) % P
    correct_sign = check == u
    flipped_sign = check == u_neg
    flipped_sign_i = check == u_neg * SQRT_M1 % P
    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P
    if _is_negative(r):
        r = P - r
    return (correct_sign or flipped_sign, r)


def _elligator(t: int) -> RistrettoPoint:
    """RFC 9496 MAP: field element -> ristretto point."""
    r = SQRT_M1 * t % P * t % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = (-1 - r * D) % P * ((r + D) % P) % P
    was_square, s = _sqrt_ratio(u, v)
    s_prime = s * t % P
    if not _is_negative(s_prime):
        s_prime = P - s_prime  # s_prime = -ABS(s*t)
    if not was_square:
        s = s_prime
        c = r
    else:
        c = P - 1
    n = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ - v) % P
    w0 = 2 * s * v % P
    w1 = n * SQRT_AD_MINUS_ONE % P
    ss = s * s % P
    w2 = (1 - ss) % P
    w3 = (1 + ss) % P
    return RistrettoPoint(w0 * w3, w2 * w1, w1 * w3, w0 * w2)


class FixedBaseTable:
    """Precomputed 8-bit-window multiples of a fixed base point.

    table[w][d-1] = d * 256^w * base for w in 0..31, d in 1..255, so a
    scalar multiplication is at most 32 point additions and no doublings —
    ~7x faster than the generic 4-bit ladder.  Used for the Pedersen bases
    B / B_blinding, which every commitment multiplies (dalek reaches for
    its own basepoint tables in the same spot)."""

    __slots__ = ("table",)

    def __init__(self, base: RistrettoPoint):
        table = []
        step = base
        for _ in range(32):
            row = [step]
            for _ in range(254):
                row.append(row[-1] + step)
            table.append(row)
            step = row[-1] + step  # 256^w * base -> 256^(w+1) * base
        self.table = table

    def mul(self, s: Scalar) -> RistrettoPoint:
        k = s.v
        acc = None
        w = 0
        while k:
            d = k & 255
            if d:
                e = self.table[w][d - 1]
                acc = e if acc is None else acc + e
            k >>= 8
            w += 1
        return RistrettoPoint.identity() if acc is None else acc


def multiscalar_mul(scalars, points) -> RistrettoPoint:
    """Host Pippenger MSM (variable time).

    Used for small MSMs and as the reference oracle for the TPU MSM kernels
    (:mod:`..ops.msm`).  Window size picked from problem size like dalek.
    """
    scalars = list(scalars)
    points = list(points)
    assert len(scalars) == len(points)
    n = len(scalars)
    if n == 0:
        return RistrettoPoint.identity()
    if n < 4:
        acc = RistrettoPoint.identity()
        for s, pt in zip(scalars, points):
            acc = acc + pt.scalar_mul(s)
        return acc
    w = 3 if n < 32 else (6 if n < 500 else (7 if n < 800 else 8))
    num_buckets = 1 << w
    num_windows = (253 + w - 1) // w
    acc = RistrettoPoint.identity()
    for win in range(num_windows - 1, -1, -1):
        if win != num_windows - 1:
            for _ in range(w):
                acc = acc.double()
        buckets = [None] * num_buckets
        shift = win * w
        for s, pt in zip(scalars, points):
            digit = (s.v >> shift) & (num_buckets - 1)
            if digit:
                buckets[digit] = pt if buckets[digit] is None else buckets[digit] + pt
        # sum_{d} d * bucket[d] via running suffix sums
        run = RistrettoPoint.identity()
        win_sum = RistrettoPoint.identity()
        for d in range(num_buckets - 1, 0, -1):
            if buckets[d] is not None:
                run = run + buckets[d]
            win_sum = win_sum + run
        acc = acc + win_sum
    return acc
