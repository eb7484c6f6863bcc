"""The ristretto255 group in plain torch (batched) and in Python ints.

Points are extended twisted-Edwards coordinates (X : Y : Z : T) of the
curve -x^2 + y^2 = 1 + d x^2 y^2, stacked as a (..., 4, 10) limb tensor
(``field``).  Encoding, decoding and the Elligator map follow RFC 9496;
addition is add-2008-hwcd-3 and doubling dbl-2008-hwcd.  ``msm`` sums
many scalar multiples on the device: each point's table of its multiples
0..15, one gather per 4-bit window, a tree sum over the points, and the
64 window sums combined by Horner in Python ints.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import field as fe

P = fe.P
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = 2 * D % P


def _is_neg(x: int) -> bool:
    return (x % P) & 1 == 1


def _sqrt(x: int) -> int:
    x %= P
    r = pow(x, (P + 3) // 8, P)
    if r * r % P != x:
        r = r * pow(2, (P - 1) // 4, P) % P
    if r * r % P != x:
        raise ValueError("not a square")
    return P - r if _is_neg(r) else r


SQRT_M1 = _sqrt(P - 1)
INVSQRT_A_MINUS_D = pow(_sqrt((-1 - D) % P), P - 2, P)
INVSQRT_A_MINUS_D = P - INVSQRT_A_MINUS_D if _is_neg(INVSQRT_A_MINUS_D) \
    else INVSQRT_A_MINUS_D
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P
# curve25519-dalek's SQRT_AD_MINUS_ONE is the odd ("negative") root
SQRT_AD_MINUS_ONE = P - _sqrt(-(D + 1) % P)
BASE_Y = 4 * pow(5, P - 2, P) % P
BASE_X = _sqrt((BASE_Y * BASE_Y - 1) * pow(D * BASE_Y * BASE_Y + 1, P - 2, P))
BASEPOINT = (BASE_X, BASE_Y, 1, BASE_X * BASE_Y % P)
IDENTITY = (0, 1, 1, 0)


# ------------------------------------------------------------ Python ints
def hadd(p, q):
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * D2 % P * T2 % P
    Dd = 2 * Z1 * Z2 % P
    E, F, G, H = B - A, Dd - C, Dd + C, B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def hdbl(p):
    return hadd(p, p)


def h_is_identity(p) -> bool:
    return p[0] % P == 0 or p[1] % P == 0


# ------------------------------------------------------------ torch batched
_CONSTS: dict = {}


def _c(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    got = _CONSTS.get(key)
    if got is None:
        got = fe.const(globals()[name] if name != "ONE" else 1, device)
        _CONSTS[key] = got
    return got


def from_host(points, device) -> torch.Tensor:
    flat = [c for p in points for c in p]
    return fe.from_ints(flat, device).reshape(len(points), 4, fe.NLIMBS)


def to_host(pts: torch.Tensor) -> list[tuple]:
    v = fe.to_ints(pts.reshape(-1, 4, fe.NLIMBS))
    return [tuple(v[4 * i:4 * i + 4]) for i in range(len(v) // 4)]


def identity(shape, device) -> torch.Tensor:
    out = torch.zeros(tuple(shape) + (4, fe.NLIMBS), dtype=torch.int64,
                      device=device)
    out[..., 1, 0] = 1
    out[..., 2, 0] = 1
    return out


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    X1, Y1, Z1, T1 = p.unbind(-2)
    X2, Y2, Z2, T2 = q.unbind(-2)
    A = fe.mul(Y1 - X1, Y2 - X2)
    B = fe.mul(Y1 + X1, Y2 + X2)
    C = fe.mul(fe.mul(T1, _c("D2", p.device)), T2)
    Dd = fe.mul(Z1, Z2)
    Dd = Dd + Dd
    E, F, G, H = B - A, Dd - C, Dd + C, B + A
    return torch.stack([fe.mul(E, F), fe.mul(G, H), fe.mul(F, G),
                        fe.mul(E, H)], -2)


def dbl(p: torch.Tensor) -> torch.Tensor:
    X1, Y1, Z1, _ = p.unbind(-2)
    A = fe.sq(X1)
    B = fe.sq(Y1)
    C = fe.sq(Z1)
    C = C + C
    E = fe.sq(X1 + Y1) - A - B
    G = B - A  # D + B with D = -A
    F = G - C
    H = -A - B  # D - B
    return torch.stack([fe.mul(E, F), fe.mul(G, H), fe.mul(F, G),
                        fe.mul(E, H)], -2)


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor):
    dev = u.device
    v3 = fe.mul(fe.sq(v), v)
    v7 = fe.mul(fe.sq(v3), v)
    r = fe.mul(fe.mul(u, v3), fe.pow_p58(fe.mul(u, v7)))
    check = fe.mul(v, fe.sq(r))
    correct = fe.eq(check, u)
    flipped = fe.eq(check, -u)
    flipped_i = fe.eq(check, fe.mul(-u, _c("SQRT_M1", dev)))
    r = fe.select(flipped | flipped_i, fe.mul(r, _c("SQRT_M1", dev)), r)
    return correct | flipped, fe.absolute(r)


def decompress(raw: torch.Tensor):
    """(N, 32) uint8 encodings -> ((N, 4, 10) points, (N,) valid)."""
    dev = raw.device
    s = fe.from_bytes(raw, mask_top=False)
    canon = (fe.to_bytes(s) == raw).all(-1)
    ok = canon & ~fe.is_negative(s)
    one = _c("ONE", dev)
    ss = fe.sq(s)
    u1 = one - ss
    u2 = one + ss
    u2_sq = fe.sq(u2)
    v = -fe.mul(_c("D", dev), fe.sq(u1)) - u2_sq
    was_sq, invsqrt = sqrt_ratio_m1(one.expand_as(v), fe.mul(v, u2_sq))
    den_x = fe.mul(invsqrt, u2)
    den_y = fe.mul(fe.mul(invsqrt, den_x), v)
    x = fe.absolute(fe.mul(s + s, den_x))
    y = fe.mul(u1, den_y)
    t = fe.mul(x, y)
    ok = ok & was_sq & ~fe.is_negative(t) & ~fe.is_zero(y)
    return torch.stack([x, y, one.expand_as(x), t], -2), ok


def compress(p: torch.Tensor) -> torch.Tensor:
    dev = p.device
    X0, Y0, Z0, T0 = p.unbind(-2)
    one = _c("ONE", dev)
    u1 = fe.mul(Z0 + Y0, Z0 - Y0)
    u2 = fe.mul(X0, Y0)
    _, invsqrt = sqrt_ratio_m1(one.expand_as(u1), fe.mul(u1, fe.sq(u2)))
    den1 = fe.mul(invsqrt, u1)
    den2 = fe.mul(invsqrt, u2)
    z_inv = fe.mul(fe.mul(den1, den2), T0)
    ix0 = fe.mul(X0, _c("SQRT_M1", dev))
    iy0 = fe.mul(Y0, _c("SQRT_M1", dev))
    enchanted = fe.mul(den1, _c("INVSQRT_A_MINUS_D", dev))
    rotate = fe.is_negative(fe.mul(T0, z_inv))
    x = fe.select(rotate, iy0, X0)
    y = fe.select(rotate, ix0, Y0)
    den_inv = fe.select(rotate, enchanted, den2)
    y = fe.cneg(fe.is_negative(fe.mul(x, z_inv)), y)
    s = fe.absolute(fe.mul(den_inv, Z0 - y))
    return fe.to_bytes(s)


def elligator(t: torch.Tensor) -> torch.Tensor:
    dev = t.device
    one = _c("ONE", dev)
    d = _c("D", dev)
    r = fe.mul(_c("SQRT_M1", dev), fe.sq(t))
    u = fe.mul(r + one, _c("ONE_MINUS_D_SQ", dev))
    v = fe.mul(-one - fe.mul(r, d), r + d)
    was_sq, s = sqrt_ratio_m1(u, v)
    s_prime = -fe.absolute(fe.mul(s, t))
    s = fe.select(was_sq, s, s_prime)
    c = fe.select(was_sq, (-one).expand_as(r), r)
    N = fe.mul(fe.mul(c, r - one), _c("D_MINUS_ONE_SQ", dev)) - v
    ss = fe.sq(s)
    w0 = fe.mul(s + s, v)
    w1 = fe.mul(N, _c("SQRT_AD_MINUS_ONE", dev))
    w2 = one - ss
    w3 = one + ss
    return torch.stack([fe.mul(w0, w3), fe.mul(w2, w1), fe.mul(w1, w3),
                        fe.mul(w0, w2)], -2)


def from_uniform(raw: torch.Tensor) -> torch.Tensor:
    """(N, 64) uint8 -> points: the sum of the Elligator maps of the two
    halves."""
    t = fe.from_bytes(torch.stack([raw[:, :32], raw[:, 32:]], 1))
    pts = elligator(t)
    return add(pts[:, 0], pts[:, 1])


def generator_chain(label: bytes, n: int, device, chunk: int = 1 << 17):
    """The first n points of the SHAKE-256 generator chain ``label`` (the
    Bulletproofs generators): 64 bytes of the stream each, mapped by
    ``from_uniform``."""
    h = hashlib.shake_256()
    h.update(b"GeneratorsChain")
    h.update(label)
    stream = np.frombuffer(h.digest(64 * n), dtype=np.uint8).reshape(n, 64)
    out = []
    for i in range(0, n, chunk):
        raw = torch.from_numpy(stream[i:i + chunk].copy()).to(device)
        out.append(from_uniform(raw))
    return torch.cat(out)


def hash_to_group(data: bytes, device) -> torch.Tensor:
    raw = np.frombuffer(hashlib.sha3_512(data).digest(), dtype=np.uint8)
    return from_uniform(torch.from_numpy(raw.copy()).to(device)[None])[0]


# ------------------------------------------------------------------- MSM
def nibbles(scalars: list[int]) -> np.ndarray:
    """(n, 64) 4-bit digits of scalars (reduced mod l), least first."""
    raw = b"".join((s % L).to_bytes(32, "little") for s in scalars)
    b = np.frombuffer(raw, dtype=np.uint8).reshape(len(scalars), 32)
    return np.stack([b & 15, b >> 4], -1).reshape(len(scalars), 64)


def _tree_sum(pts: torch.Tensor) -> torch.Tensor:
    """Sum over dim -3 of (..., m, 4, 10) points."""
    while pts.shape[-3] > 1:
        m = pts.shape[-3]
        if m % 2:
            pad = identity(pts.shape[:-3] + (1,), pts.device)
            pts = torch.cat([pts, pad], -3)
            m += 1
        pts = add(pts[..., : m // 2, :, :], pts[..., m // 2:, :, :])
    return pts[..., 0, :, :]


def msm(points: torch.Tensor, scalars: list[int], window_batch: int = 16,
        lane_chunk: int = 1 << 18):
    """sum_i scalars[i] * points[i], as a Python-int point."""
    n = points.shape[0]
    dev = points.device
    digits = torch.from_numpy(nibbles(scalars).astype(np.int64)).to(dev)
    sums = [IDENTITY] * 64
    for lo in range(0, n, lane_chunk):
        pts = points[lo:lo + lane_chunk]
        m = pts.shape[0]
        table = [identity((m,), dev), pts]
        for k in range(2, 16):
            table.append(dbl(table[k // 2]) if k % 2 == 0
                         else add(table[k - 1], pts))
        table = torch.stack(table, 1)  # (m, 16, 4, 10)
        rows = torch.arange(m, device=dev)
        for w0 in range(0, 64, window_batch):
            d = digits[lo:lo + m, w0:w0 + window_batch]  # (m, wb)
            picked = table[rows[:, None], d]  # (m, wb, 4, 10)
            tot = _tree_sum(picked.transpose(0, 1))  # (wb, 4, 10)
            for j, p in enumerate(to_host(tot)):
                sums[w0 + j] = hadd(sums[w0 + j], p)
        del table
    acc = IDENTITY
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = hdbl(acc)
        acc = hadd(acc, sums[w])
    return acc


def comb_table(base, device) -> torch.Tensor:
    """(64, 16, 4, 10): d * 16^w * base for windows w and digits d."""
    rows, b = [], base
    for _ in range(64):
        row, acc = [IDENTITY], IDENTITY
        for _ in range(15):
            acc = hadd(acc, b)
            row.append(acc)
        rows.append(row)
        for _ in range(4):
            b = hdbl(b)
    flat = [p for row in rows for p in row]
    return from_host(flat, device).reshape(64, 16, 4, fe.NLIMBS)


def fixed_base(tables: list[torch.Tensor], scalars: list[list[int]]):
    """(m, 4, 10) points sum_t scalars[t][j] * base_t for each j, from
    ``comb_table`` tables of the bases."""
    dev = tables[0].device
    picked = []
    for tbl, sc in zip(tables, scalars):
        d = torch.from_numpy(nibbles(sc).astype(np.int64)).to(dev)  # (m, 64)
        picked.append(tbl[torch.arange(64, device=dev)[None, :], d])
    return _tree_sum(torch.cat(picked, 1))
