"""GF(2^255 - 19) on torch int64 tensors, in plain torch operations.

An element is a tensor whose last dimension holds ten signed limbs of
radix 2^26: value = sum_k limb_k * 2^(26 k).  Sums and differences are
plain tensor sums; ``mul`` takes limbs up to 2^28 in magnitude (so any
sum of four carried elements), forms the 19 schoolbook columns (each
below 2^60), carries them once, folds the ten high limbs down by
2^260 = 608 (mod p) and carries twice more, leaving limbs in
[-2^11, 2^26 + 2^11].  ``canonical`` reduces exactly to [0, p).

This is the benchmark's own arithmetic: it shares nothing with the
program under test.
"""

from __future__ import annotations

import torch

P = 2**255 - 19
RADIX = 26
NLIMBS = 10
MASK = (1 << RADIX) - 1
FOLD = (1 << (RADIX * NLIMBS)) % P  # 2^260 mod p = 608


def from_ints(values, device) -> torch.Tensor:
    """(len(values), 10) limbs of Python ints (reduced mod p)."""
    rows = []
    for v in values:
        v %= P
        rows.append([(v >> (RADIX * k)) & MASK for k in range(NLIMBS)])
    return torch.tensor(rows, dtype=torch.int64, device=device).reshape(
        len(rows), NLIMBS)


def const(v: int, device) -> torch.Tensor:
    return from_ints([v], device)[0]


def to_ints(t: torch.Tensor) -> list[int]:
    """The canonical values of a (..., 10) tensor, flattened."""
    rows = canonical(t).reshape(-1, NLIMBS).tolist()
    return [sum(limb << (RADIX * k) for k, limb in enumerate(r)) for r in rows]


def carry(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry: each limb keeps its low 26 bits and passes the
    rest up; the top limb's carry re-enters limb 0 times 608."""
    hi = x >> RADIX
    return (x & MASK) + torch.cat([hi[..., 9:] * FOLD, hi[..., :9]], -1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(a.shape, b.shape)
    cols = torch.zeros(shape[:-1] + (2 * NLIMBS - 1,), dtype=torch.int64,
                       device=a.device)
    for i in range(NLIMBS):
        cols[..., i:i + NLIMBS] += a[..., i:i + 1] * b
    hi = cols >> RADIX
    c = torch.cat([cols & MASK, torch.zeros_like(cols[..., :1])], -1)
    c[..., 1:] += hi
    return carry(carry(c[..., :NLIMBS] + FOLD * c[..., NLIMBS:]))


def sq(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def pow2k(a: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        a = sq(a)
    return a


def _pow22501(a):
    """(a^(2^250 - 1), a^11): the shared head of the inversion and the
    square-root exponent (the usual curve25519 addition chain)."""
    t0 = sq(a)
    t1 = mul(a, pow2k(t0, 2))
    t0 = mul(t0, t1)
    t1 = mul(t1, sq(t0))
    t1 = mul(pow2k(t1, 5), t1)
    t2 = mul(pow2k(t1, 10), t1)
    t2 = mul(pow2k(t2, 20), t2)
    t1 = mul(pow2k(t2, 10), t1)
    t2 = mul(pow2k(t1, 50), t1)
    t2 = mul(pow2k(t2, 100), t2)
    t1 = mul(pow2k(t2, 50), t1)
    return t1, t0


def invert(a: torch.Tensor) -> torch.Tensor:
    """a^(p - 2); 0 maps to 0."""
    t, a11 = _pow22501(a)
    return mul(pow2k(t, 5), a11)


def pow_p58(a: torch.Tensor) -> torch.Tensor:
    """a^((p - 5) / 8) = a^(2^252 - 3)."""
    t, _ = _pow22501(a)
    return mul(pow2k(t, 2), a)


def _seq_carry(x: torch.Tensor, wrap: bool) -> None:
    for k in range(NLIMBS - 1):
        c = x[..., k] >> RADIX
        x[..., k] &= MASK
        x[..., k + 1] += c
    if wrap:
        c = x[..., 9] >> RADIX
        x[..., 9] &= MASK
        x[..., 0] += FOLD * c


def canonical(a: torch.Tensor) -> torch.Tensor:
    """The same elements with limbs of their values in [0, p)."""
    x = a.clone()
    for _ in range(3):
        _seq_carry(x, wrap=True)
    top = RADIX * NLIMBS - 255  # bits of limb 9 at or above 2^255
    for _ in range(2):
        c = x[..., 9] >> (RADIX - top)
        x[..., 9] &= (1 << (RADIX - top)) - 1
        x[..., 0] += 19 * c
        _seq_carry(x, wrap=False)
    y = x.clone()
    y[..., 0] += 19
    _seq_carry(y, wrap=False)
    over = (y[..., 9] >> (RADIX - top)) != 0
    y[..., 9] &= (1 << (RADIX - top)) - 1
    return torch.where(over[..., None], y, x)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (canonical(a) == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(a - b)


def is_negative(a: torch.Tensor) -> torch.Tensor:
    """The low bit of the canonical encoding."""
    return (canonical(a)[..., 0] & 1) == 1


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where mask, else b."""
    return torch.where(mask[..., None], a, b)


def cneg(mask: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return select(mask, -a, a)


def absolute(a: torch.Tensor) -> torch.Tensor:
    return cneg(is_negative(a), a)


def from_bytes(raw: torch.Tensor, mask_top: bool = True) -> torch.Tensor:
    """(..., 32) uint8 little-endian encodings -> limbs; bit 255 dropped
    when ``mask_top`` (as a field element's decoding does)."""
    b = raw.to(torch.int64)
    if mask_top:
        b = b.clone()
        b[..., 31] &= 0x7F
    w = b[..., 0::2] | (b[..., 1::2] << 8)  # 16 words of 16 bits
    w = torch.cat([w, torch.zeros_like(w[..., :2])], -1)
    limbs = []
    for k in range(NLIMBS):
        j, off = divmod(RADIX * k, 16)
        v = (w[..., j] >> off) | (w[..., j + 1] << (16 - off)) \
            | (w[..., j + 2] << (32 - off))
        limbs.append(v & MASK)
    return torch.stack(limbs, -1)


def to_bytes(a: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 canonical little-endian encodings."""
    x = canonical(a)
    out = []
    for i in range(32):
        k, off = divmod(8 * i, RADIX)
        v = x[..., k] >> off
        if off > RADIX - 8 and k + 1 < NLIMBS:
            v = v | (x[..., k + 1] << (RADIX - off))
        out.append(v & 0xFF)
    return torch.stack(out, -1).to(torch.uint8)
