"""Field layout, codecs and plain torch arithmetic mod p = 2^255 - 19.

Boundary layout.  A batch of points is an ``(n, 4, 8)`` int32 tensor: the
X, Y, Z, T coordinates as eight little-endian 32-bit words each.  That is
byte for byte ``BulletproofGens.G_raw`` / ``H_raw`` (128 B per point), so
uploading generators is a view and one copy.  Values may be any integer
below 2^256; outputs of the kernels and of the plain versions are
canonical (every coordinate in [0, p)).

Plain arithmetic.  Inside the plain versions a field element is sixteen
int64 limbs of radix 2^16 (``(..., 16)``), non-negative and not unique.
The overflow argument (2^256 == 38 mod p):

* ``mul`` takes limbs < 2^22.  Limb products are < 2^44 and each of the
  31 product columns sums at most 16 of them, < 2^48; folding the high
  half as ``low + 38 * high`` gives < 39 * 2^48 < 2^54, far from 2^63.
* ``carry`` then runs five parallel rounds (limb -> low 16 bits, carry to
  the next limb, top carry times 38 to limb 0): the bound falls 2^54 ->
  2^43 -> 2^33 -> 2^22 -> 2^17 -> < 2^16 + 39, so products come out with
  limbs < 2^17.
* ``add`` of two such values has limbs < 2^18; ``sub(a, b)`` adds the
  constant ``SUBC`` (a multiple of p whose limbs all lie in
  [2^17, 2^17 + 2^19)) so it never goes negative for b < 2^17 and gives
  limbs < 2^20.  The point formulas combine at most one add and one sub
  before a multiply (F = C + G in the doubling: < 2^21), inside the 2^22
  that ``mul`` takes.  ``neg`` carries its result back below 2^17, since
  a negated coordinate is later subtracted.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ristretto import RistrettoPoint
from ..utils.constants import P

NLIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
JAX_LIMB_BITS = 12  # the JAX package's balanced limb radix
JAX_STORE = 23


def int_to_limbs(x: int) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & MASK for i in range(NLIMBS)]


def limbs_to_int(limbs) -> int:
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs))


def _subc() -> list[int]:
    base = sum(1 << (17 + LIMB_BITS * i) for i in range(NLIMBS))
    rest = 8 * P - base
    assert rest > 0
    limbs = [(1 << 17) + v for v in int_to_limbs(rest)]
    top = rest >> (LIMB_BITS * NLIMBS)
    limbs[-1] += top << LIMB_BITS
    assert limbs_to_int(limbs) == 8 * P
    assert all((1 << 17) <= v < (1 << 17) + (1 << 19) for v in limbs)
    return limbs


SUBC = _subc()
P_LIMBS = int_to_limbs(P)

_consts: dict = {}


def _const(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    got = _consts.get(key)
    if got is None:
        if name == "subc":
            got = torch.tensor(SUBC, dtype=torch.int64, device=device)
        elif name == "diag":
            i = torch.arange(NLIMBS, device=device)
            got = (i[:, None] + i[None, :]).reshape(-1)
        else:
            raise KeyError(name)
        _consts[key] = got
    return got


def const_limbs(x: int, device) -> torch.Tensor:
    return torch.tensor(int_to_limbs(x % P), dtype=torch.int64, device=device)


# ------------------------------------------------------------ arithmetic
def carry(x: torch.Tensor, rounds: int = 5) -> torch.Tensor:
    for _ in range(rounds):
        c = x >> LIMB_BITS
        x = (x & MASK) + torch.cat([38 * c[..., -1:], c[..., :-1]], dim=-1)
    return x


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + _const("subc", a.device) - b


def neg(a: torch.Tensor) -> torch.Tensor:
    """-a with limbs < 2^17 again (a negated point feeds ``sub`` as b)."""
    return carry(_const("subc", a.device) - a, rounds=2)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)
    cols = torch.zeros(
        prod.shape[:-1] + (2 * NLIMBS,), dtype=torch.int64, device=a.device
    )
    cols.index_add_(-1, _const("diag", a.device), prod)
    return carry(cols[..., :NLIMBS] + 38 * cols[..., NLIMBS:])


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Limbs < 2^22 -> the unique representative in [0, p), exact 16-bit
    limbs.  Sequential carries, then at most two subtractions of p."""
    x = carry(x)
    limbs = list(x.unbind(-1))
    for _ in range(3):
        for i in range(NLIMBS - 1):
            c = limbs[i] >> LIMB_BITS
            limbs[i] = limbs[i] & MASK
            limbs[i + 1] = limbs[i + 1] + c
        c = limbs[-1] >> LIMB_BITS
        limbs[-1] = limbs[-1] & MASK
        limbs[0] = limbs[0] + 38 * c
    # value < 2^256 < 3p now, in exact limbs
    for _ in range(2):
        d, borrow = [], torch.zeros_like(limbs[0])
        for i in range(NLIMBS):
            v = limbs[i] - P_LIMBS[i] - borrow
            borrow = (v < 0).to(torch.int64)
            d.append(v + (borrow << LIMB_BITS))
        keep = borrow.bool()
        limbs = [torch.where(keep, a, b) for a, b in zip(limbs, d)]
    return torch.stack(limbs, dim=-1)


# ------------------------------------------------------------- codecs
def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 16) int64 radix-2^16 limbs."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u & MASK, u >> LIMB_BITS], dim=-1).flatten(-2)


def limbs_to_words(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) limbs -> (..., 8) int32 canonical words."""
    c = canonical(x)
    u = c[..., 0::2] | (c[..., 1::2] << LIMB_BITS)
    u = u - ((u >> 31) << 32)  # two's complement int32 range
    return u.to(torch.int32)


def ints_to_words(coords: list[int]) -> np.ndarray:
    """Python ints (each < 2^256) -> (len, 8) int32 words."""
    buf = b"".join(int(c).to_bytes(32, "little") for c in coords)
    return np.frombuffer(buf, dtype="<i4").reshape(len(coords), 8)


def words_to_ints(w: np.ndarray) -> list[int]:
    buf = np.ascontiguousarray(w, dtype="<i4").tobytes()
    return [
        int.from_bytes(buf[32 * i : 32 * (i + 1)], "little")
        for i in range(len(buf) // 32)
    ]


def from_points(points: list[RistrettoPoint], device="cpu") -> torch.Tensor:
    """Host points -> (n, 4, 8) int32 tensor on `device`."""
    coords = [c for pt in points for c in (pt.X, pt.Y, pt.Z, pt.T)]
    w = ints_to_words(coords).reshape(len(points), 4, 8)
    return torch.from_numpy(w.copy()).to(device)


def to_points(t: torch.Tensor) -> list[RistrettoPoint]:
    """(n, 4, 8) tensor -> host points (coordinates taken mod p)."""
    ints = words_to_ints(t.detach().cpu().numpy())
    return [
        RistrettoPoint(*(ints[4 * i + c] % P for c in range(4)))
        for i in range(len(ints) // 4)
    ]


def from_raw(raw: np.ndarray, device="cpu") -> torch.Tensor:
    """``BulletproofGens.G_raw`` (n, 4, 16) uint16 -> (n, 4, 8) int32."""
    w = np.ascontiguousarray(raw, dtype="<u2").view("<i4")
    return torch.from_numpy(w.reshape(raw.shape[0], 4, 8).copy()).to(device)


def identity_points(n: int, device="cpu") -> torch.Tensor:
    out = torch.zeros((n, 4, 8), dtype=torch.int32, device=device)
    out[:, 1, 0] = 1
    out[:, 2, 0] = 1
    return out


def from_jax_limbs(limbs: np.ndarray, device="cpu") -> torch.Tensor:
    """(n, 4, 23) balanced 12-bit int32 limbs (the JAX package's point
    layout, ``BulletproofGens.G_limbs``) -> (n, 4, 8) canonical words."""
    arr = np.asarray(limbs)
    n = arr.shape[0]
    coords = []
    for row in arr.reshape(n * 4, JAX_STORE).tolist():
        coords.append(
            sum(v << (JAX_LIMB_BITS * i) for i, v in enumerate(row)) % P
        )
    w = ints_to_words(coords).reshape(n, 4, 8)
    return torch.from_numpy(w.copy()).to(device)


def from_jax_chunk(chunk, device="cpu") -> torch.Tensor:
    """One (92, 8, 256) JAX point chunk (2048 points, point-major within
    the flattened 8 x 256 lattice) -> (2048, 4, 8) canonical words."""
    a = np.asarray(chunk)
    rows, npts = a.shape[0], a.shape[1] * a.shape[2]
    flat = a.reshape(rows, npts).T.reshape(npts, 4, JAX_STORE)
    return from_jax_limbs(flat, device)
