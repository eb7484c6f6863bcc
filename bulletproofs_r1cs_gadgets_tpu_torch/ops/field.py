"""Field layout, codecs, plain torch arithmetic mod p and mod l, and
``LimbField`` (the JAX package's ``ops/field.py`` API: ``FQ`` mod l, ``FP``
mod p) on the port's words.

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

``LimbField`` (the end of this module) holds elements as ``(..., 8)``
int32 words, canonical, on one device.  Its ``mul`` / ``square`` are the
``mul_fq`` / ``mul_fp`` kernels (``ops/cuda_curve.py``); everything else is
plain torch mod-m arithmetic over 32-bit word limbs in int64, which the
JAX package leaves to XLA outside any kernel.  The plain version of
``mul_fq`` is :func:`mul_mod_plain`, the kernel's Barrett reduction;
that of ``mul_fp`` is :func:`mul` above.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ristretto import RistrettoPoint
from ..utils import metrics
from ..utils.constants import L, P

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


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device`: every copy of the backend's
    data to its device goes through here, and adds its bytes to the
    ``h2d_bytes`` count of the innermost open span (``utils/metrics``;
    counted on a CPU device too, where no copy is made)."""
    t = torch.from_numpy(arr)
    metrics.count("h2d_bytes", t.nbytes)
    return t.to(device)


def from_points(points: list[RistrettoPoint], device="cpu") -> torch.Tensor:
    """Host points -> (n, 4, 8) int32 tensor on `device`."""
    coords = [c for pt in points for c in (pt.X, pt.Y, pt.Z, pt.T)]
    w = ints_to_words(coords).reshape(len(points), 4, 8)
    return upload(w.copy(), device)


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
    return upload(w.reshape(raw.shape[0], 4, 8).copy(), device)


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
    return upload(w.copy(), device)


def from_jax_chunk(chunk, device="cpu") -> torch.Tensor:
    """One (92, 8, lanes) JAX point block (8 * lanes points, point-major
    within the flattened 8 x lanes lattice; a 2048-point chunk at 256
    lanes) -> (8 * lanes, 4, 8) canonical words."""
    a = np.asarray(chunk)
    rows, npts = a.shape[0], a.shape[1] * a.shape[2]
    flat = a.reshape(rows, npts).T.reshape(npts, 4, JAX_STORE)
    return from_jax_limbs(flat, device)


# ------------------------------------------------ plain mod-m arithmetic
# Word limbs: 32-bit words held in int64.  Products are taken in radix
# 2^16 (16-bit limb products stay below 2^32, a column of at most 18 of
# them below 2^37) and their columns paired back into words (< 2^54)
# before the sequential carries.
_WMASK = 0xFFFFFFFF
_conv_idx: dict = {}


def _u(w: torch.Tensor) -> torch.Tensor:
    """(..., k) int32 words -> int64 values in [0, 2^32)."""
    return w.to(torch.int64) & _WMASK


def _norm32(x: torch.Tensor) -> torch.Tensor:
    """Sequential carries over the last axis of word limbs: every limb
    but the last in [0, 2^32), the last keeps the rest (signed)."""
    x = x.clone()
    for i in range(x.shape[-1] - 1):
        x[..., i + 1] += x[..., i] >> 32
        x[..., i] &= _WMASK
    return x


def _i32(u: torch.Tensor) -> torch.Tensor:
    """Exact words in [0, 2^32) -> int32 (two's complement)."""
    return (u - ((u >> 31) << 32)).to(torch.int32)


def _halves(u: torch.Tensor) -> torch.Tensor:
    """(..., k) exact words -> (..., 2k) radix-2^16 limbs."""
    return torch.stack([u & MASK, u >> LIMB_BITS], dim=-1).flatten(-2)


def _mul_words(a: torch.Tensor, b: torch.Tensor, nwords: int) -> torch.Tensor:
    """Exact words (..., i), (..., j) -> the product's first `nwords` word
    columns (int64, not carried): one outer product of 16-bit limbs, its
    diagonals summed, pairs of columns joined."""
    la, lb = _halves(a), _halves(b)
    n, m = la.shape[-1], lb.shape[-1]
    key = (n, m, str(a.device))
    idx = _conv_idx.get(key)
    if idx is None:
        i = torch.arange(n, device=a.device)
        j = torch.arange(m, device=a.device)
        idx = (i[:, None] + j[None, :]).reshape(-1)
        _conv_idx[key] = idx
    prod = (la.unsqueeze(-1) * lb.unsqueeze(-2)).flatten(-2)
    cols = torch.zeros(prod.shape[:-1] + (2 * nwords + n + m,),
                       dtype=torch.int64, device=a.device)
    cols.index_add_(-1, idx, prod)
    cols = cols[..., : 2 * nwords]
    return cols[..., 0::2] + (cols[..., 1::2] << LIMB_BITS)


def _int_words(x: int, n: int, device) -> torch.Tensor:
    return torch.tensor([(x >> (32 * i)) & _WMASK for i in range(n)],
                        dtype=torch.int64, device=device)


def mul_mod_plain(a: torch.Tensor, b: torch.Tensor, modulus: int
                  ) -> torch.Tensor:
    """(..., 8) int32 words, any values below 2^256 -> a * b mod `modulus`
    as canonical words, for a modulus of 225..256 bits: the mul_fq
    kernel's reduction, Barrett's with base 2^32 and k = 8 words (Handbook
    of Applied Cryptography 14.42): q3 = floor(floor(x / 2^224) * mu /
    2^288), r = (x - q3 * m) mod 2^288 < 3m, then at most two subtractions
    of m."""
    assert 1 << 224 <= modulus < 1 << 256
    dev = a.device
    mu = _int_words((1 << 512) // modulus, 9, dev)
    m9 = _int_words(modulus, 9, dev)
    x = _norm32(_mul_words(_u(a), _u(b), 16))
    q2 = _norm32(_mul_words(x[..., 7:16], mu, 18))
    r = _norm32(x[..., :9] - _mul_words(q2[..., 9:18], m9, 9))
    r[..., 8] &= _WMASK  # mod 2^288: r is in [0, 3m)
    cand = _norm32(torch.stack([r - 2 * m9, r - m9, r]))
    ok = cand[..., 8] >= 0
    out = torch.where(ok[0, ..., None], cand[0],
                      torch.where(ok[1, ..., None], cand[1], cand[2]))
    return _i32(out[..., :8])


def _pad_limbs(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad (or cut) the last axis to n limbs."""
    k = x.shape[-1]
    if k >= n:
        return x[..., :n]
    return torch.nn.functional.pad(x, (0, n - k))


class LimbField:
    """Arithmetic mod ``modulus`` on ``(..., 8)`` int32 words, the
    canonical residue of each element, on the elements' device (the JAX
    package's ``LimbField``, ``ops/field.py:106``, on lazy balanced
    12-bit limbs).  ``mul`` and ``square`` launch ``kernel`` (``mul_fq``
    or ``mul_fp``) on a CUDA tensor and run its plain version on a CPU
    one; the rest is plain torch.  Constructors take an explicit device,
    the card by default."""

    def __init__(self, modulus: int, kernel: str):
        self.modulus = modulus
        self.kernel = kernel
        bl = modulus.bit_length()
        # quotient estimates value >> qshift stay within one of the true
        # quotient: l lies just above 2^252, p just below 2^255
        if modulus - (1 << (bl - 1)) < 1 << (bl - 64):
            self._qshift = bl - 1
        else:
            assert (1 << bl) - modulus < 1 << (bl - 64)
            self._qshift = bl
        assert 224 <= self._qshift <= 256
        self._mwords = [(modulus >> (32 * i)) & _WMASK for i in range(8)]
        self._consts: dict = {}

    def _m9(self, device) -> torch.Tensor:
        key = ("m9", str(device))
        got = self._consts.get(key)
        if got is None:
            got = torch.tensor(self._mwords + [0], dtype=torch.int64,
                               device=device)
            self._consts[key] = got
        return got

    # -- codecs -------------------------------------------------------------
    def to_device(self, xs, device="cuda") -> torch.Tensor:
        """Python ints -> (len, 8) words mod the modulus on `device`."""
        w = ints_to_words([int(x) % self.modulus for x in xs])
        return upload(w.copy(), device)

    def to_ints(self, a: torch.Tensor) -> list[int]:
        flat = a.detach().reshape(-1, 8).cpu().numpy()
        return [x % self.modulus for x in words_to_ints(flat)]

    def constant(self, x: int, device="cuda") -> torch.Tensor:
        return self.to_device([x], device)[0]

    def zeros(self, shape, device="cuda") -> torch.Tensor:
        return torch.zeros(tuple(shape) + (8,), dtype=torch.int32,
                           device=device)

    # -- reduction ----------------------------------------------------------
    def _fix(self, t: torch.Tensor) -> torch.Tensor:
        """(..., 9) word limbs of a value in [-m, 2m) -> canonical words:
        the one of t - m, t, t + m that lies in [0, m)."""
        m9 = self._m9(t.device)
        cand = _norm32(torch.stack([t - m9, t, t + m9]))
        ok = cand[..., 8] >= 0
        out = torch.where(ok[0, ..., None], cand[0],
                          torch.where(ok[1, ..., None], cand[1], cand[2]))
        return _i32(out[..., :8])

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 9) non-negative word limbs, value below 2^(qshift + 20)
        -> canonical words: subtract the estimated quotient's multiple
        (off by at most one), then :meth:`_fix`."""
        x = _norm32(x)
        s = self._qshift - 224
        q = (x[..., 7] >> s) | (x[..., 8] << (32 - s)) if s < 32 else x[..., 8]
        return self._fix(x - q[..., None] * self._m9(x.device))

    def canonicalize(self, a: torch.Tensor) -> torch.Tensor:
        """Any words below 2^256 -> the canonical residue (elements are
        canonical already, so this is the identity on them)."""
        return self._reduce(_pad_limbs(_u(a), 9))

    # -- ring ops -----------------------------------------------------------
    def add(self, a, b):
        return self._fix(_pad_limbs(_u(a) + _u(b), 9))

    def sub(self, a, b):
        return self._fix(_pad_limbs(_u(a) - _u(b), 9))

    def neg(self, a):
        return self._fix(_pad_limbs(-_u(a), 9))

    def sum(self, a, dim: int):
        """Sum mod m of the elements along `dim` (not the word axis)."""
        return self._reduce(_pad_limbs(_u(a).sum(dim=dim), 9))

    def mul(self, a, b):
        from . import cuda_curve as cc

        kern = cc.mul_fq if self.kernel == "fq" else cc.mul_fp
        a, b = torch.broadcast_tensors(a, b)
        shape = a.shape
        out = kern(a.reshape(-1, 8).contiguous(), b.reshape(-1, 8).contiguous())
        return out.reshape(shape)

    def square(self, a):
        return self.mul(a, a)

    def scale_small(self, a, k: int):
        """Multiply by a small integer constant |k| < 2^15."""
        assert abs(k) < 1 << 15
        out = self._reduce(_pad_limbs(_u(a) * abs(k), 9))
        return self.neg(out) if k < 0 else out

    # -- powers -------------------------------------------------------------
    def pow_const(self, a, e: int):
        """a^e for a host-known exponent, square-and-multiply from the top
        bit (one kernel launch per square and per set bit)."""
        if e == 0:
            return self.constant(1, a.device).expand(a.shape).clone()
        bits = bin(e)[3:]
        acc = a
        for bit in bits:
            acc = self.square(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Fermat inverse; inv(0) == 0 (dalek semantics)."""
        return self.pow_const(a, self.modulus - 2)

    def batch_inv(self, a):
        """The Fermat inverse of every element (as the JAX package: one
        branch-free exponentiation over the whole batch)."""
        return self.inv(a)

    def select(self, cond, a, b):
        c = cond
        while c.ndim < a.ndim:
            c = c[..., None]
        return torch.where(c, a, b)

    def to_bits(self, a, nbits: int = 253) -> torch.Tensor:
        """Canonical LSB-first bit matrix (..., nbits) int32."""
        u = _u(self.canonicalize(a))
        pos = torch.arange(nbits, device=a.device)
        return ((u[..., pos // 32] >> (pos % 32)) & 1).to(torch.int32)

    def eq(self, a, b) -> torch.Tensor:
        return (self.canonicalize(a) == self.canonicalize(b)).all(dim=-1)


# Scalar field Z/l and curve base field Z/p (ops/field.py:307-309 there).
FQ = LimbField(L, "fq")
FP = LimbField(P, "fp")
