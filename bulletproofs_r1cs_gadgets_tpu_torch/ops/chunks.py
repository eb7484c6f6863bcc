"""Host-side word encoders and flat point packing for the port's kernels.

Counterparts of the numpy encoders in the JAX package's ``ops/chunks.py``,
which cannot be imported here (it imports JAX).  The digit and word
encodings are the reference's, so each kernel consumes exactly what its
TPU kernel consumes:

* MSM words: signed 4-bit digits d_i in [-8, 7], nibble code d & 15,
  sum d_i 16^i == scalar (``signed_digit_words``, ``_signed_recode``).
* w5 walker words: 51 signed base-32 digits d_i in [-16, 15], one per
  byte (code d & 31), sum d_i 32^i == scalar (``signed_digit5_bytes``).
* Fold words: the scalar's raw little-endian 32-bit words
  (``scvec.words_u32``, as ``tail_fold`` and ``const_words`` use).
* Half-width fold words: a fold constant c split as alpha / beta with
  |alpha|, |beta| < 2^127 (``half_gcd_split``), each as 44 signed base-8
  digits in [-4, 3], one per nibble (``w3h_digit_words``); a fold takes
  one (beta, alpha) pair below the breakpoint and another beyond it (the
  reference's ``_pw_w3h_rows`` expands them per point; the port's kernels
  take the two pairs and the breakpoint).
* Constant fold words: a fold's two constants as MSM words, one row each
  (``c_fold_words``; the reference's ``_c_fold_words`` writes one row per
  point).
* w2 fold words (``fold_grid``): 128 signed base-4 digits d_i in [-2, 1],
  two bits each (code d & 3), sum d_i 4^i == scalar
  (``signed_digit2_words``); a constant scalar is one row that every lane
  reads (``const_grid_words``; the reference writes the row into every
  lane of a capacity array).

Scalars arrive as ``(n, 4) uint64`` numpy arrays (``core/scvec.py``) and
are encoded in numpy into int32 rows, which ``field.upload`` copies to
the device.

The JAX package packs points into fixed 2048-point chunks because every
new kernel shape costs a Mosaic compile; the port's tensors are flat
``(n, 4, 8)`` and one launch covers any n.  On a flat layout the
chunk-list rounds and the tail rounds of the IPP are the same
computation: :func:`pack_pair` with :func:`segment_words` serves both
(flat counterparts of ``_tail_pack_pair``, ``tail_pair_words`` and
``segment_words``; the frozen tail's ``frozen_pair_words`` is
``segment_words`` too), and :func:`fold_words` serves
``fold_chunks`` and ``tail_fold`` (whose ``_tail_shift`` is a slice
here).  The flotilla's pack (``flotilla_pack`` / ``flotilla_words``)
keeps the reference's segment order with segments of the batch's
largest frozen pack instead of 2048-point chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import scvec
from ..core.ristretto import RistrettoPoint
from . import cuda_curve as cc
from . import field as F

W5_WINDOWS = cc.W5_WINDOWS
# The reference's chunk: the unit of the points-axis sharded walk
# (``parallel/sharded_fast.py``), which reads it at call time, so tests
# lower it.
CHUNK = 2048


def shard_valid(valid: int, d: int, local_chunks: int) -> int:
    """Live chunks of shard d in a walk over `valid` live chunks, each
    shard `local_chunks` wide: shard d spans chunks [d * lc, (d + 1) * lc)
    and sees clip(valid - d * lc, 0, lc) of them
    (sharded_fast.py:149-155)."""
    return min(max(valid - d * local_chunks, 0), local_chunks)


def _limbs(c: int) -> np.ndarray:
    return np.array(
        [(c >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)], dtype="<u8"
    )


_W4_C = _limbs(sum(8 << (4 * i) for i in range(64)))
_W5_C = _limbs(sum(16 << (5 * i) for i in range(W5_WINDOWS)))
_W2_C = _limbs(sum(2 << (2 * i) for i in range(cc.W2_WINDOWS)))  # 0xAA..AA


def _signed_recode(arr: np.ndarray, C: np.ndarray) -> np.ndarray:
    """(scalar + C) ^ C, as (m, 4) u64 limbs, for a constant C (4 limbs)
    holding 2^(w-1) in every w-bit group: the w-bit codes of signed
    digits in [-2^(w-1), 2^(w-1)) that sum to the scalar (one carried
    4-limb add and an XOR)."""
    a = np.ascontiguousarray(arr, dtype="<u8")
    t = np.empty_like(a)
    carry = np.zeros(a.shape[0], np.uint64)
    with np.errstate(over="ignore"):
        for i in range(4):
            s = a[:, i] + C[i]
            c_new = s < a[:, i]
            t[:, i] = s + carry
            carry = (c_new | (t[:, i] < s)).astype(np.uint64)
    # scalars are < L < 2^253 and C < 2^256 - 2^253: no carry out
    assert not carry.any(), "signed-digit recode overflow"
    return t ^ C


def signed_digit_words(arr: np.ndarray) -> np.ndarray:
    """(m, 4) u64 scalars -> (m, 8) int32 packed signed nibble digits.
    A zero scalar encodes as zero words (adds nothing)."""
    t = _signed_recode(arr, _W4_C)
    return t.view("<u4").view(np.int32).reshape(arr.shape[0], 8)


def signed_digit2_words(arr: np.ndarray) -> np.ndarray:
    """(m, 4) u64 scalars -> (m, 8) int32 packed 2-bit signed digits d_i in
    [-2, 1], sum d_i * 4^i == scalar (code d & 3; the reference's
    ``signed_digit2_words``, chunks.py:190).  Zero encodes as zero words."""
    t = _signed_recode(arr, _W2_C)
    return t.view("<u4").view(np.int32).reshape(arr.shape[0], 8)


def w2_words(arr: np.ndarray, device) -> torch.Tensor:
    """Per-lane ``fold_grid`` words of scalar rows on `device`."""
    return F.upload(signed_digit2_words(arr), device)


def const_grid_words(s, device) -> torch.Tensor:
    """The (1, 8) ``fold_grid`` word row of scalar `s`, read by every lane
    (in place of the reference's capacity array holding it in every lane,
    ``const_grid_words`` :297)."""
    return w2_words(scvec.scalar_to_row(s)[None], device)


def fold_big(points: torch.Tensor, wl: torch.Tensor, wr: torch.Tensor,
             valid_out: int) -> torch.Tensor:
    """Generator fold: out[i] = wl[i] * P[i] + wr[i] * P[i + v] for i < v =
    `valid_out` points (the reference's ``fold_big`` :328 counts 2048-point
    chunks of a capacity array); w2 words per lane or one constant row.
    One ``fold_grid`` launch into a new (v, 4, 8) tensor."""
    return cc.fold_grid(points, wl, wr, valid_out)


_POS5 = 5 * np.arange(W5_WINDOWS)


def _digit5_bytes(t: torch.Tensor) -> torch.Tensor:
    """(m, 4) int64 recoded limbs (``_signed_recode`` with the w5
    constant) -> (m, 16) int32 holding the 51 5-bit codes, one per byte.
    Runs on t's device: each code is read from the two bytes it spans."""
    dev = t.device
    by = t.view(torch.uint8)  # (m, 32), little-endian
    b = F.upload(_POS5 >> 3, dev)
    lo = by[:, b].to(torch.int32)
    hi = by[:, (b + 1).clamp(max=31)].to(torch.int32)
    sh = F.upload((_POS5 & 7).astype(np.int32), dev)
    codes = ((lo | (hi << 8)) >> sh) & 31
    out = torch.zeros((t.shape[0], 64), dtype=torch.uint8, device=dev)
    out[:, :W5_WINDOWS] = codes.to(torch.uint8)
    return out.view(torch.int32)


def _recode5(arr: np.ndarray, device) -> torch.Tensor:
    t = _signed_recode(arr, _W5_C).view(np.int64)
    return F.upload(t, device)


def signed_digit5_bytes(arr: np.ndarray) -> np.ndarray:
    """(m, 4) u64 scalars -> (m, 16) int32 packing 51 signed base-32
    digits, one per byte (byte i holds digit i's code d & 31).  A zero
    scalar encodes as zero words."""
    return _digit5_bytes(_recode5(arr, "cpu")).numpy()


def w5_words(arr: np.ndarray, device) -> torch.Tensor:
    """w5 walker word rows (``msm_win5``) on `device`: the scalars'
    recoded limbs are uploaded (32 B per row) and split into digit bytes
    there."""
    return _digit5_bytes(_recode5(arr, device))


W3H_DIGITS = 44  # 3-bit signed digits covering |x| < 2^130 (half-width)


def w3h_digit_words(x: int) -> np.ndarray:
    """Signed int |x| < 2^130 -> (8,) int32 packed 3-bit signed digits,
    one per nibble: x = sum d_i 8^i, d_i in [-4, 3], nibble code d & 7
    (0 adds nothing; e >= 4 is the digit e - 8)."""
    assert abs(x) < 1 << 130
    C = 4 * ((1 << (3 * W3H_DIGITS)) - 1) // 7  # 4 in every digit
    t = x + C
    assert 0 <= t < 1 << (3 * W3H_DIGITS)
    buf = 0
    for i in range(W3H_DIGITS):
        # q in 0..7, d = q - 4 in -4..3, code d & 7 = q ^ 4
        buf |= (((t >> (3 * i)) & 7) ^ 4) << (4 * i)
    return np.frombuffer(buf.to_bytes(32, "little"), dtype="<i4").astype(np.int32)


def half_gcd_split(c: int, mod: int) -> tuple[int, int]:
    """Signed (alpha, beta) with alpha == beta * c (mod `mod`) and
    |alpha|, |beta| < 2^127 for a 253-bit modulus: the extended-GCD
    midpoint (the first remainder below 2^127 has |t| <= mod / r_prev
    < 2^126).  A fold by c then runs as the half-width dual ladder
    beta * L + alpha * R, with beta^-1 carried in the factor vectors."""
    c %= mod
    if c == 0:
        return 0, 1
    r0, r1 = mod, c
    t0, t1 = 0, 1
    while r1 >= 1 << 127:
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        t0, t1 = t1, t0 - q * t1
    assert abs(t1) < 1 << 127 and (r1 - t1 * c) % mod == 0
    return r1, t1


def w3h_fold_words(sides, device) -> torch.Tensor:
    """Fold words for ``fold_w3h`` (one side) or ``fold_w3h_comb`` (two):
    `sides` lists one ((alpha_A, beta_A), (alpha_B, beta_B)) pair of
    :func:`half_gcd_split` results per side.  Returns (sides, 2, 2, 8)
    int32: [side][pair][beta digits, alpha digits]."""
    w = np.stack([
        np.stack([np.stack([w3h_digit_words(beta), w3h_digit_words(alpha)])
                  for alpha, beta in pairs])
        for pairs in sides
    ])
    return F.upload(np.ascontiguousarray(w), device)


def c_fold_words(sides, device) -> torch.Tensor:
    """Fold words for ``fold_c`` (one side) or ``fold_c_comb`` (two):
    `sides` lists one (c_A, c_B) pair of constants (Scalars) per side, c_A
    for outputs below the breakpoint and c_B from it on.  Returns
    (sides, 2, 8) int32, each row the constant's signed w4 digit words:
    the two distinct rows of the reference's per-point ``_c_fold_words``
    (``_c_fold_words_comb`` for two sides)."""
    rows = np.stack([scvec.scalar_to_row(c) for pair in sides for c in pair])
    w = signed_digit_words(rows).reshape(len(sides), 2, 8)
    return F.upload(np.ascontiguousarray(w), device)


def comb_walks(n: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """``msm_win_pair``'s two walks (v, poff, woff, split, poff2) for a
    combined round of side n over the table of [G(2n) | H(2n)] with words
    [scG_L | scH_L | scG_R | scH_R] (``ck.msm_win_pair``): L walks table
    rows [n, 3n) with words [0, 2n); R walks rows [0, n) then [3n, 4n)
    with words [2n, 4n)."""
    return (2 * n, n, 0, 2 * n, n), (2 * n, 0, 2 * n, n, 3 * n)


def bit_words(arr: np.ndarray) -> np.ndarray:
    """(m, 4) u64 scalars -> (m, 8) int32 raw little-endian bit words."""
    return np.ascontiguousarray(scvec.words_u32(arr).view(np.int32))


def w4_words(arr: np.ndarray, device) -> torch.Tensor:
    return F.upload(signed_digit_words(arr), device)


def segment_words(segments: list[np.ndarray], device) -> torch.Tensor:
    """MSM words for concatenated point segments, one scalar array each."""
    return w4_words(np.concatenate(segments), device)


def const_rows(s, n: int) -> np.ndarray:
    """(n, 4) u64 rows, all equal to scalar `s`."""
    return np.tile(scvec.scalar_to_row(s), (n, 1))


def fold_words(arr: np.ndarray, device) -> torch.Tensor:
    """Bit-word rows of ``fold_bits`` launches, (m, 8) int32: one side's,
    or several sides' rows concatenated (one upload)."""
    return F.upload(bit_words(arr), device)


# ---------------------------------------------------------- point packing
def pack_pair(G: torch.Tensor, H: torch.Tensor, n: int):
    """IPP round L/R point packing over vectors of length 2n:
    ptsL = [G[n..2n) | H[0..n)], ptsR = [G[0..n) | H[n..2n)]."""
    ptsL = torch.cat([G[n : 2 * n], H[:n]])
    ptsR = torch.cat([G[:n], H[n : 2 * n]])
    return ptsL, ptsR


def frozen_pack(G: torch.Tensor, H: torch.Tensor, S: int) -> torch.Tensor:
    """Frozen-tail pack [G(S) | H(S)], (2S, 4, 8) (``frozen_pack_chunk``):
    the flotilla's input; duplicated (``_frozen_dup``) it is the pair
    kernel's, which walks the L words over the first copy and the R words
    over the second."""
    return torch.cat([G[:S], H[:S]])


def flotilla_pack(packs: list[torch.Tensor], seg: int) -> torch.Tensor:
    """B frozen packs [G(S_j) | H(S_j)] -> ONE (2B * seg, 4, 8) point array
    for ``msm_lane``: job j's pack, identity padded to `seg` points, at
    segments 2j and 2j+1 (L and R walks)."""
    out = []
    for p in packs:
        pad = F.identity_points(seg - p.shape[0], p.device)
        padded = torch.cat([p, pad])
        out.extend([padded, padded])
    return torch.cat(out)


def flotilla_words(rows_pairs: list[tuple[np.ndarray, np.ndarray]],
                   seg: int, device) -> torch.Tensor:
    """B (rowsL, rowsR) composite-scalar row pairs -> w4 words matching
    :func:`flotilla_pack`: job j's L rows at segment 2j, R rows at 2j+1,
    zero rows (adding nothing) beyond each."""
    arr = np.zeros((2 * len(rows_pairs) * seg, 4), np.uint64)
    for j, (rowsL, rowsR) in enumerate(rows_pairs):
        arr[2 * j * seg : 2 * j * seg + rowsL.shape[0]] = rowsL
        arr[(2 * j + 1) * seg : (2 * j + 1) * seg + rowsR.shape[0]] = rowsR
    return w4_words(arr, device)


# ------------------------------------------------------------ MSM chain
def msm_chain(points: torch.Tensor, words: torch.Tensor, acc=None):
    """Chained MSM ``acc + sum d_i P_i`` as ONE launch over all points
    (the JAX package chains one launch per 2048-point chunk).  Returns
    the (1, 4, 8) accumulator on the device, no sync."""
    if acc is None:
        acc = F.identity_points(1, points.device)
    return cc.msm_w4(points, words, acc)


# ------------------------------------------------------------ fetching
def fetch_points(accs: list[torch.Tensor]) -> list[RistrettoPoint]:
    """ONE device sync for a handful of (k, 4, 8) accumulators."""
    return F.to_points(torch.cat(accs))
