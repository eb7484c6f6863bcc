"""Vectorized scalar-field vectors: numpy ``(n, 4) uint64`` arrays mod L.

The dalek engine the reference builds on runs its O(n) prover loops (vector
polynomials, IPP folds, inner products — SURVEY.md S2b N6/N7) as Rust
iterator chains over ``Scalar``.  Round 1 ported those as Python loops over
``Scalar`` objects, which made the warm prove ~40% host Python.  This module
is the replacement: scalars are rows of a little-endian 4x64-bit limb array,
and the loops run in C (``native/bptpu_native.cpp``).  The same layout
reinterprets as ``(n, 8) uint32`` little-endian words — exactly the packed
scalar format the Pallas MSM kernels consume (``ops/pallas_curve.words_matrix``)
— so device uploads become zero-copy views.

A pure-Python fallback keeps every op available when the native library
cannot build; it is exact (int math) but slow.
"""

from __future__ import annotations

import ctypes
import secrets

import numpy as np

from ..utils.constants import L
from .scalar import Scalar

try:
    from ..native import _native as _NATIVE
except Exception:  # pragma: no cover
    _NATIVE = None

_LIB = _NATIVE._lib if _NATIVE is not None else None

_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_longlong)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _out_like(a: np.ndarray) -> np.ndarray:
    return np.empty_like(a)


# ------------------------------------------------------------- conversions
def from_ints(xs) -> np.ndarray:
    buf = b"".join((x % L).to_bytes(32, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u8").reshape(len(xs), 4).copy()


def from_scalars(xs) -> np.ndarray:
    buf = b"".join(
        (s.v if s.v < L else s.v % L).to_bytes(32, "little") for s in xs
    )
    return np.frombuffer(buf, dtype="<u8").reshape(len(xs), 4).copy()


def to_ints(arr: np.ndarray) -> list[int]:
    b = np.ascontiguousarray(arr, dtype="<u8").tobytes()
    return [
        int.from_bytes(b[32 * i : 32 * (i + 1)], "little")
        for i in range(arr.shape[0])
    ]


def to_scalars(arr: np.ndarray) -> list[Scalar]:
    return [Scalar(v) for v in to_ints(arr)]


def scalar_to_row(s) -> np.ndarray:
    v = s.v if isinstance(s, Scalar) else int(s)
    return np.frombuffer((v % L).to_bytes(32, "little"), dtype="<u8").copy()


def row_to_scalar(row: np.ndarray) -> Scalar:
    return Scalar(int.from_bytes(row.tobytes(), "little"))


def zeros(n: int) -> np.ndarray:
    return np.zeros((n, 4), dtype=np.uint64)


def words_u32(arr: np.ndarray) -> np.ndarray:
    """(n, 4) u64 -> (n, 8) u32 little-endian words (zero-copy on LE hosts);
    matches ``ops.pallas_curve.words_matrix`` output exactly."""
    a = np.ascontiguousarray(arr, dtype="<u8")
    return a.view("<u4").reshape(arr.shape[0], 8)


# ------------------------------------------------------------- vector ops
def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if _LIB is None:
        return from_ints(
            [(x * y) % L for x, y in zip(to_ints(a), to_ints(b))]
        )
    out = _out_like(a)
    _LIB.sc_vec_mul(_ptr(a), _ptr(b), _ptr(out), len(a))
    return out


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if _LIB is None:
        return from_ints(
            [(x + y) % L for x, y in zip(to_ints(a), to_ints(b))]
        )
    out = _out_like(a)
    _LIB.sc_vec_add(_ptr(a), _ptr(b), _ptr(out), len(a))
    return out


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if _LIB is None:
        return from_ints(
            [(x - y) % L for x, y in zip(to_ints(a), to_ints(b))]
        )
    out = _out_like(a)
    _LIB.sc_vec_sub(_ptr(a), _ptr(b), _ptr(out), len(a))
    return out


def scale(a: np.ndarray, s) -> np.ndarray:
    row = scalar_to_row(s)
    if _LIB is None:
        sv = int.from_bytes(row.tobytes(), "little")
        return from_ints([(x * sv) % L for x in to_ints(a)])
    out = _out_like(a)
    _LIB.sc_vec_scale(_ptr(a), _ptr(row), _ptr(out), len(a))
    return out


def axpby(a: np.ndarray, x, b: np.ndarray, y) -> np.ndarray:
    """out_i = a_i * x + b_i * y (the IPP fold primitive)."""
    rx, ry = scalar_to_row(x), scalar_to_row(y)
    if _LIB is None:
        xv = int.from_bytes(rx.tobytes(), "little")
        yv = int.from_bytes(ry.tobytes(), "little")
        return from_ints(
            [(u * xv + w * yv) % L for u, w in zip(to_ints(a), to_ints(b))]
        )
    out = _out_like(a)
    _LIB.sc_vec_axpby(_ptr(a), _ptr(rx), _ptr(b), _ptr(ry), _ptr(out), len(a))
    return out


def inner(a: np.ndarray, b: np.ndarray) -> Scalar:
    if _LIB is None:
        return Scalar(
            sum(x * y for x, y in zip(to_ints(a), to_ints(b))) % L
        )
    out = np.zeros(4, dtype=np.uint64)
    _LIB.sc_vec_inner(_ptr(a), _ptr(b), len(a), _ptr(out))
    return row_to_scalar(out)


def _powers_serial(base_row: np.ndarray, n: int) -> np.ndarray:
    out = zeros(n)
    _LIB.sc_vec_powers(_ptr(base_row), _ptr(out), n)
    return out


def powers(base, n: int) -> np.ndarray:
    row = scalar_to_row(base)
    bv = int.from_bytes(row.tobytes(), "little")
    if _LIB is None:
        out, cur = [], 1
        for _ in range(n):
            out.append(cur)
            cur = cur * bv % L
        return from_ints(out)
    m = 512
    if n <= 2 * m:
        return _powers_serial(row, n)
    # blocked: out[j*m + i] = (base^m)^j * base^i — the serial chain is
    # latency-bound (~10x slower per element than the independent-element
    # vector mul), so build two sqrt-length chains and one vector multiply.
    nblk = -(-n // m)
    small = _powers_serial(row, m)
    big = _powers_serial(scalar_to_row(pow(bv, m, L)), nblk)
    out = mul(
        np.repeat(big, m, axis=0)[:n],
        np.tile(small, (nblk, 1))[:n],
    )
    return out


def batch_inv(a: np.ndarray) -> np.ndarray:
    if _LIB is None:
        return from_ints(
            [pow(x, L - 2, L) if x else 0 for x in to_ints(a)]
        )
    out = _out_like(a)
    _LIB.sc_vec_batch_inv(_ptr(a), _ptr(out), len(a))
    return out


def from_wide_bytes(data: bytes) -> np.ndarray:
    """64-byte little-endian chunks -> canonical scalars (wide reduction)."""
    n = len(data) // 64
    if _LIB is None:
        return from_ints(
            [
                int.from_bytes(data[64 * i : 64 * (i + 1)], "little") % L
                for i in range(n)
            ]
        )
    out = zeros(n)
    _LIB.sc_vec_from_wide(data, _ptr(out), n)
    return out


def random(n: int) -> np.ndarray:
    """n uniform scalars from the system CSPRNG (wide reduction, like
    dalek's ``Scalar::random``)."""
    return from_wide_bytes(secrets.token_bytes(64 * n))


def flatten_terms(
    zpow: np.ndarray,
    coeff: np.ndarray,
    cidx: np.ndarray,
    widx: np.ndarray,
    nwires: int,
) -> np.ndarray:
    """out[widx[t]] += zpow[cidx[t]] * coeff[t] over all tape terms t."""
    out = zeros(nwires)
    m = len(cidx)
    if m == 0:
        return out
    if _LIB is None:
        zi = to_ints(zpow)
        ci = to_ints(coeff)
        acc = [0] * nwires
        for t in range(m):
            acc[int(widx[t])] = (
                acc[int(widx[t])] + zi[int(cidx[t])] * ci[t]
            ) % L
        return from_ints(acc)
    cidx = np.ascontiguousarray(cidx, dtype=np.int64)
    widx = np.ascontiguousarray(widx, dtype=np.int64)
    _LIB.sc_flatten(
        _ptr(zpow), _ptr(coeff), _iptr(cidx), _iptr(widx), m, _ptr(out)
    )
    return out
