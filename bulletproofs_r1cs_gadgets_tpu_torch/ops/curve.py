"""Points on extended Edwards coordinates (a = -1): plain torch limb
operations, and the JAX package's ``ops/curve.py`` API on the port's
words.

Plain limb operations: counterparts of the JAX package's point emitters
in ``ops/pallas_curve.py`` (``emit_point_add`` :60, ``emit_point_double``
:83, ``emit_point_select`` :148, ``_identity_point`` :154,
``emit_block_reduce`` :203, ``emit_point_negate`` :305) and of
``core/ristretto.py``'s group law.  A batch of points is an
``(n, 4, 16)`` int64 limb tensor (X, Y, Z, T in the radix-2^16 form of
:mod:`.field`).  The four multiplies of each formula stage run as one
batched multiply over the coordinate axis.  The plain versions use the
full formulas; the T-elided variants of the TPU kernels are a speed trick
left to the kernels.  Every kernel's plain version (``ops/cuda_curve.py``)
is built on them.  They carry a ``_limbs`` suffix (``point_add_limbs``,
``point_double_limbs``, ``point_select_limbs``) so that the JAX names mean
here what they mean there.

The JAX API (``points_to_device`` ... ``from_uniform_bytes_batch``,
JAX ``ops/curve.py:66-276``): points are ``(..., 4, 8)`` int32 words on a
device, canonical.  ``point_add`` / ``point_double`` launch the ``padd`` /
``pdbl`` kernels, ``scalar_mul_bits`` the ``smul_lanes`` kernel, and the
field work of ``sqrt_ratio`` / ``elligator_map`` runs on ``FP``
(:class:`.field.LimbField`, whose multiplies are the ``mul_fp`` kernel).
On a CPU tensor every kernel runs its plain version.
"""

from __future__ import annotations

import torch

import numpy as np

from ..core.ristretto import RistrettoPoint
from ..utils.constants import (
    D,
    D2,
    D_MINUS_ONE_SQ,
    ONE_MINUS_D_SQ,
    P,
    SQRT_AD_MINUS_ONE,
    SQRT_M1,
)
from . import cuda_curve as cc
from . import field as F
from .field import FP

_d2: dict = {}


def _d2_limbs(device) -> torch.Tensor:
    key = str(device)
    if key not in _d2:
        _d2[key] = F.const_limbs(D2, device)
    return _d2[key]


def identity(n: int, device) -> torch.Tensor:
    out = torch.zeros((n, 4, F.NLIMBS), dtype=torch.int64, device=device)
    out[:, 1, 0] = 1
    out[:, 2, 0] = 1
    return out


def point_add_limbs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """add-2008-hwcd-3 (unified, a = -1, 2d constant)."""
    X1, Y1, Z1, T1 = p.unbind(-2)
    X2, Y2, Z2, T2 = q.unbind(-2)
    lhs = torch.stack([F.sub(Y1, X1), F.add(Y1, X1), T1, Z1], dim=-2)
    rhs = torch.stack([F.sub(Y2, X2), F.add(Y2, X2), T2, Z2], dim=-2)
    A, B, TT, ZZ = F.mul(lhs, rhs).unbind(-2)
    C = F.mul(TT, _d2_limbs(p.device))
    Dv = F.add(ZZ, ZZ)
    E, Fv, G, H = F.sub(B, A), F.sub(Dv, C), F.add(Dv, C), F.add(B, A)
    return F.mul(
        torch.stack([E, G, Fv, E], dim=-2), torch.stack([Fv, H, G, H], dim=-2)
    )


def to_niels(p: torch.Tensor) -> torch.Tensor:
    """Extended -> niels form (Y+X, Y-X, 2d*T, Z) (``_to_niels`` :934)."""
    X, Y, Z, T = p.unbind(-2)
    return torch.stack(
        [F.add(Y, X), F.sub(Y, X), F.mul(T, _d2_limbs(p.device)), Z], dim=-2
    )


def niels_negate(q: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Niels -P where `mask` is true: swap Y+X with Y-X, negate 2dT."""
    ypx, ymx, t2d, Z = q.unbind(-2)
    m = mask[..., None]
    return torch.stack(
        [torch.where(m, ymx, ypx), torch.where(m, ypx, ymx),
         torch.where(m, F.neg(t2d), t2d), Z],
        dim=-2,
    )


def point_add_niels(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p (extended) + q (niels): ``emit_point_add_niels`` :949, the
    add-2008-hwcd-3 formula with q's sums and 2d product precomputed."""
    X1, Y1, Z1, T1 = p.unbind(-2)
    ypx, ymx, t2d, Z2 = q.unbind(-2)
    lhs = torch.stack([F.sub(Y1, X1), F.add(Y1, X1), T1, Z1], dim=-2)
    rhs = torch.stack([ymx, ypx, t2d, Z2], dim=-2)
    A, B, C, ZZ = F.mul(lhs, rhs).unbind(-2)
    Dv = F.add(ZZ, ZZ)
    E, Fv, G, H = F.sub(B, A), F.sub(Dv, C), F.add(Dv, C), F.add(B, A)
    return F.mul(
        torch.stack([E, G, Fv, E], dim=-2), torch.stack([Fv, H, G, H], dim=-2)
    )


def point_double_limbs(p: torch.Tensor) -> torch.Tensor:
    """dbl-2008-hwcd (a = -1); reads X, Y, Z."""
    X1, Y1, Z1, _ = p.unbind(-2)
    s = torch.stack([X1, Y1, Z1, F.add(X1, Y1)], dim=-2)
    A, B, ZZ, S = F.mul(s, s).unbind(-2)
    C = F.add(ZZ, ZZ)
    H = F.add(A, B)
    E = F.sub(H, S)
    G = F.sub(A, B)
    Fv = F.add(C, G)
    return F.mul(
        torch.stack([E, G, Fv, E], dim=-2), torch.stack([Fv, H, G, H], dim=-2)
    )


def point_negate(p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z, T) -> (-X, Y, Z, -T) where `mask` (n,) is true."""
    X, Y, Z, T = p.unbind(-2)
    m = mask[..., None]
    return torch.stack(
        [torch.where(m, F.neg(X), X), Y, Z, torch.where(m, F.neg(T), T)],
        dim=-2,
    )


def point_select_limbs(mask: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """Per point: p where `mask` (n,) is true, else q."""
    return torch.where(mask[..., None, None], p, q)


def block_reduce(p: torch.Tensor) -> torch.Tensor:
    """(..., n, 4, 16) -> (..., 1, 4, 16) group sums over the point axis
    by a halving add tree."""
    n = p.shape[-3]
    if n == 0:
        return identity(1, p.device).expand(*p.shape[:-3], 1, 4, F.NLIMBS)
    while n > 1:
        if n % 2:
            pad = identity(1, p.device).expand(*p.shape[:-3], 1, 4, F.NLIMBS)
            p = torch.cat([p, pad], dim=-3)
            n += 1
        p = point_add_limbs(p[..., : n // 2, :, :], p[..., n // 2 :, :, :])
        n //= 2
    return p


# ------------------------------------------------------------ the JAX API
def points_to_device(points: list[RistrettoPoint], device="cuda"
                     ) -> torch.Tensor:
    return F.from_points(points, device)


def points_from_device(arr: torch.Tensor) -> list[RistrettoPoint]:
    return F.to_points(arr.reshape(-1, 4, 8))


def identity_points(shape, device="cuda") -> torch.Tensor:
    """(*shape, 4, 8) identity points (0, 1, 1, 0)."""
    out = torch.zeros(tuple(shape) + (4, 8), dtype=torch.int32, device=device)
    out[..., 1, 0] = 1
    out[..., 2, 0] = 1
    return out


def _flat(fn, *pts) -> torch.Tensor:
    """Apply a pointwise kernel over the broadcast leading axes."""
    pts = torch.broadcast_tensors(*pts)
    shape = pts[0].shape
    return fn(*(p.reshape(-1, 4, 8).contiguous() for p in pts)).reshape(shape)


def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Unified extended-coordinate addition: the ``padd`` kernel."""
    return _flat(cc.padd, p, q)


def point_double(p: torch.Tensor) -> torch.Tensor:
    """dbl-2008-hwcd: the ``pdbl`` kernel."""
    return _flat(cc.pdbl, p)


def point_neg(p: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [FP.neg(p[..., 0, :]), p[..., 1, :], p[..., 2, :], FP.neg(p[..., 3, :])],
        dim=-2,
    )


def point_select(cond, p, q):
    """cond ? p : q, cond shaped (...)."""
    c = cond
    while c.ndim < p.ndim:
        c = c[..., None]
    return torch.where(c, p, q)


# ---------------------------------------------------- scalar multiplication
def bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """(N, nbits) LSB-first 0/1 matrix (nbits <= 253) -> (N, 8) int32 bit
    words (``ck.bit_words`` layout), on bits' device."""
    n, nbits = bits.shape
    if nbits > cc.LADDER_BITS:
        raise ValueError(f"{nbits} bits: the ladder reads bits 0..252")
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, 256 - nbits))
    shifts = torch.arange(32, device=bits.device)
    u = ((b.view(n, 8, 32) & 1) << shifts).sum(dim=-1)
    return (u - ((u >> 31) << 32)).to(torch.int32)


def scalar_mul_bits(points: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-point scalar multiplication: points (N, 4, 8), bits (N, nbits)
    LSB-first, nbits <= 253.  One ``smul_lanes`` launch over bits 252..0
    (the JAX package's bit ladder scans nbits bits; the kernel runs a
    windowed ladder: the group elements are the same)."""
    return cc.smul_lanes(points.contiguous(), bits_to_words(bits))


def scalar_mul_shared(points: torch.Tensor, scalar_int: int) -> torch.Tensor:
    """Every point times the SAME host-known scalar: double-and-add over
    its bits, one ``pdbl`` launch per bit after the first and one ``padd``
    per set bit."""
    k = int(scalar_int)
    if k == 0:
        return identity_points(points.shape[:-2], points.device)
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = point_double(acc)
        if bit == "1":
            acc = points if acc is None else point_add(acc, points)
    return acc


def tree_reduce(points: torch.Tensor) -> torch.Tensor:
    """Sum N points (N, 4, 8) -> (4, 8) by log2(N) halving ``padd``
    launches (identity-padded to a power of two)."""
    n = points.shape[0]
    pow2 = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if pow2 != n:
        pad = identity_points((pow2 - n,), points.device)
        points = torch.cat([points, pad])
    while points.shape[0] > 1:
        half = points.shape[0] // 2
        points = cc.padd(points[:half].contiguous(), points[half:].contiguous())
    return points[0]


# ------------------------------------------------------------ sqrt / hash
_P58_EXP = (P - 5) // 8


def _const(x: int, like: torch.Tensor) -> torch.Tensor:
    return FP.constant(x, like.device).expand(like.shape)


def _is_negative_fe(a: torch.Tensor) -> torch.Tensor:
    """dalek IS_NEGATIVE: the low bit of the canonical encoding."""
    return (FP.canonicalize(a)[..., 0] & 1) == 1


def _abs_fe(a: torch.Tensor) -> torch.Tensor:
    return FP.select(_is_negative_fe(a), FP.neg(a), a)


def sqrt_ratio(u: torch.Tensor, v: torch.Tensor):
    """Batched SQRT_RATIO_M1: (was_square (...,) bool, root (..., 8))."""
    v3 = FP.mul(FP.square(v), v)
    v7 = FP.mul(FP.square(v3), v)
    r = FP.mul(FP.mul(u, v3), FP.pow_const(FP.mul(u, v7), _P58_EXP))
    check = FP.mul(v, FP.square(r))
    u_neg = FP.neg(u)
    sqrt_m1 = _const(SQRT_M1, u)
    correct = FP.eq(check, u)
    flipped = FP.eq(check, u_neg)
    flipped_i = FP.eq(check, FP.mul(u_neg, sqrt_m1))
    r = FP.select(flipped | flipped_i, FP.mul(r, sqrt_m1), r)
    return correct | flipped, _abs_fe(r)


def elligator_map(t: torch.Tensor) -> torch.Tensor:
    """Batched RFC 9496 MAP: (..., 8) field elements -> (..., 4, 8)."""
    one = _const(1, t)
    d_c = _const(D, t)
    r = FP.mul(_const(SQRT_M1, t), FP.square(t))
    u = FP.mul(FP.add(r, one), _const(ONE_MINUS_D_SQ, t))
    v = FP.mul(FP.sub(FP.neg(one), FP.mul(r, d_c)), FP.add(r, d_c))
    was_square, s = sqrt_ratio(u, v)
    s_prime = FP.neg(_abs_fe(FP.mul(s, t)))
    s = FP.select(was_square, s, s_prime)
    c = FP.select(was_square, FP.neg(one), r)
    n = FP.sub(
        FP.mul(FP.mul(c, FP.sub(r, one)), _const(D_MINUS_ONE_SQ, t)), v
    )
    ss = FP.square(s)
    w0 = FP.scale_small(FP.mul(s, v), 2)
    w1 = FP.mul(n, _const(SQRT_AD_MINUS_ONE, t))
    w2 = FP.sub(one, ss)
    w3 = FP.add(one, ss)
    return torch.stack(
        [FP.mul(w0, w3), FP.mul(w2, w1), FP.mul(w1, w3), FP.mul(w0, w2)],
        dim=-2,
    )


def uniform_bytes_to_device(seeds: list[bytes], device="cuda") -> torch.Tensor:
    """(n, 4, 8) points ``from_uniform_bytes`` of 64-byte seeds, left on
    `device`: both halves' 255-bit field elements mapped in one batch,
    then one ``padd`` launch."""
    n = len(seeds)
    raw = np.frombuffer(b"".join(seeds), dtype="<u4").reshape(n, 2, 8).copy()
    raw[:, :, 7] &= 0x7FFFFFFF
    halves = np.ascontiguousarray(raw.transpose(1, 0, 2)).view(np.int32)
    t = FP.canonicalize(torch.from_numpy(halves.reshape(2 * n, 8)).to(device))
    mapped = elligator_map(t)
    return point_add(mapped[:n], mapped[n:])


def from_uniform_bytes_batch(seeds: list[bytes], device="cuda"
                             ) -> list[RistrettoPoint]:
    """Batched dalek ``RistrettoPoint::from_uniform_bytes`` for generator
    derivation (SHAKE-256 chains, ``core/pedersen.py``)."""
    return points_from_device(uniform_bytes_to_device(seeds, device))
