"""Plain torch point operations on extended Edwards coordinates (a = -1).

Counterparts of the JAX package's point emitters in ``ops/pallas_curve.py``
(``emit_point_add`` :60, ``emit_point_double`` :83, ``emit_point_select``
:148, ``_identity_point`` :154, ``emit_block_reduce`` :203,
``emit_point_negate`` :305) and of ``core/ristretto.py``'s group law.  A
batch of points is an ``(n, 4, 16)`` int64 limb tensor (X, Y, Z, T in the
radix-2^16 form of :mod:`.field`).  The four multiplies of each formula
stage run as one batched multiply over the coordinate axis.  The plain
versions use the full formulas; the T-elided variants of the TPU kernels
are a speed trick left to the kernels.
"""

from __future__ import annotations

import torch

from ..utils.constants import D2
from . import field as F

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


def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
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


def point_double(p: torch.Tensor) -> torch.Tensor:
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


def point_select(mask: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
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
        p = point_add(p[..., : n // 2, :, :], p[..., n // 2 :, :, :])
        n //= 2
    return p
