"""The operation orders of the redesigned device-oracle kernels, on the CPU.

``msm_chunk_acc`` and ``msm_block_totals`` (``csrc/win.cu``) now run the
windowed w4 MSM over raw bit words: the tiles recode each word row into
64 signed base-16 digits as they load it (``fold_recode``: bits 252..0,
the top digit taking the carry), then ``msm_w4``'s passes, chained on acc
(one segment) or with no chain over one segment of 2,048 points a total,
the last one ragged.  ``fold_grid`` (``csrc/msm_fold.cu``) recodes each
w2 word row (128 signed base-4 digits) into 64 signed base-16 digits and
a borrow window (``w2_recode``: digits paired, e = d_2j + 4 d_2j+1, below
-8 it takes 16 and lends -1 upward, window 64 the last borrow) and runs
Straus over niels tables of P[i] and P[i + v] in two designs:

* ``thread``: one thread an output; tables 2P = dbl P, then t(k-1) + P;
  65 windows of 4 doublings (T on the 4th) once a digit was added, and
  each scalar's niels add (code 0 adds nothing);
* ``group``: ``fold_bits``' cooperative tables (odd multiples doubled,
  even ones t(k-1) + P) and window loop, four outputs a warp (groups past
  v repeat output v - 1): the warp doubles once any group added and takes
  a scalar's add when any group's digit is nonzero (the others add the
  identity).

The recodes are held against Python ints; each model runs in torch, step
for step at small sizes (tiles of 4 points, blocks of ``BLOCK`` points for
the block totals, the plain version's block constants lowered to match),
and is held against the kernels' plain versions (``ops/cuda_curve.py``,
themselves held against the JAX emitters in
``tests/test_torch_oracle_kernels.py``) and the host MSM as group
elements.  Tolerance: exact (the same Edwards point: X1 Z2 = X2 Z1, Y1 Z2
= Y2 Z1).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from bulletproofs_r1cs_gadgets_tpu_torch import (
    BulletproofGens,
    L,
    PedersenGens,
    Scalar,
    multiscalar_mul,
    scvec,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import curve as C
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F
from test_torch_fold_bits import niels_tables
from test_torch_ladder import no_t, same_points, w4_model, w4_partials
from test_torch_lane_fold import lane_horner

torch.set_num_threads(1)

WARP = 4  # fold_grid's group design: outputs a warp, 8 lanes each
W2_WINDOWS = 65  # w2_recode: 64 digits and the borrow window
ALL_M2 = -0x55555556  # 0xaaaaaaaa: every w2 digit -2
HIGH_BITS = -0x20000000  # 0xe0000000: bits 253..255 of word 7 (not read)
BLOCK = 16  # the block totals' model: points a total (the kernel's 2048)


def _signed(codes) -> np.ndarray:
    codes = np.asarray(codes, np.int64)
    return np.where(codes >= 8, codes - 16, codes)


def _value16(codes) -> int:
    return sum(int(d) << (4 * j) for j, d in enumerate(_signed(codes)))


def _value_w2(row) -> int:
    """A w2 word row's value: sum of d_i 4^i, d the signed 2-bit digit."""
    total = 0
    for j, word in enumerate(int(v) & 0xFFFFFFFF for v in row):
        for t in range(16):
            c = (word >> (2 * t)) & 3
            total += (c - 4 if c >= 2 else c) << (2 * (16 * j + t))
    return total


def _value_bits(row) -> int:
    return cs.decode_bits(row) % (1 << 253)


# ---------------------------------------------------------------- recodes
def w2_codes(words) -> np.ndarray:
    """(n, 8) w2 word rows -> (n, 65) signed base-16 digit codes as
    csrc/ge25519_cc.cuh's w2_recode: nibble j holds digits 2j and 2j + 1,
    e = d_2j + 4 d_2j+1 plus the borrow, below -8 plus 16 with a borrow of
    -1 into the next window; code 64 is the last borrow (15 for -1)."""
    nib = cs._codes(np.asarray(words), 4, 64).astype(np.int64)
    e = ((nib & 3) - np.where(nib & 2, 4, 0)) + 4 * ((nib >> 2) - np.where(nib & 8, 4, 0))
    codes = np.zeros((len(nib), W2_WINDOWS), np.int64)
    borrow = np.zeros(len(nib), np.int64)
    for j in range(64):
        x = e[:, j] + borrow
        low = x < -8
        borrow = np.where(low, -1, 0)
        codes[:, j] = np.where(low, x + 16, x) & 15
    codes[:, 64] = np.where(borrow < 0, 15, 0)
    return codes


def bit_codes(words) -> np.ndarray:
    """(n, 8) bit word rows -> (n, 64) codes, as fold_recode (the tiles'
    recode of msm_chunk_acc / msm_block_totals)."""
    return cs.fold_codes(np.asarray(words))


def tile_words(words) -> torch.Tensor:
    """(n, 8) bit word rows -> the (n, 8) w4 words the tiles hold in
    shared memory after their recode: chip_smoke's, which also counts the
    bit-word MSMs' bounds."""
    return torch.from_numpy(cs.bit_w4_words(np.asarray(words)).copy())


def _w2_rows(kind: str, n: int, seed: int) -> np.ndarray:
    if kind == "all-2":
        return np.full((n, 8), ALL_M2, np.int32)
    rows = scvec.from_wide_bytes(np.random.RandomState(seed).bytes(64 * n))
    edge = {"zero": 0, "one": 1, "L-1": L - 1}.get(kind)
    if edge is not None:
        rows[:] = scvec.from_ints([edge] * n)
    return ck.signed_digit2_words(rows)


@pytest.mark.parametrize("kind", ["zero", "one", "L-1", "all-2", "random"])
def test_w2_recode_holds_the_row_value(kind):
    """The 65 digits sum to the row's value as a Python int, each in [-8,
    7]; for a canonical scalar window 64 is 0, window 63 at most 2, and the
    digits are fold_recode's of the scalar's bit words (a base-16
    representation with digits in [-8, 7] is unique); the all -2 row (not a
    scalar, value -2 (4^128 - 1) / 3) needs window 64."""
    words = _w2_rows(kind, 6, 700)
    codes = w2_codes(words)
    for row, c in zip(words, codes):
        assert _value16(c) == _value_w2(row)
    if kind == "all-2":
        assert _value_w2(words[0]) == -2 * ((1 << 256) - 1) // 3
        assert (codes[:, 64] == 15).all()
        return
    assert (codes[:, 64] == 0).all() and _signed(codes[:, 63]).max() <= 2
    rows = [_value_w2(r) for r in words]
    assert all(0 <= r < L for r in rows)
    bits = ck.bit_words(scvec.from_ints(rows))
    assert np.array_equal(codes[:, :64], bit_codes(bits))


@pytest.mark.parametrize("kind", ["random", "zero", "L-1", "high", "high only"])
def test_bit_recode_at_the_tile_load(kind):
    """The tiles' recode of bit word rows: the packed w4 digits hold bits
    252..0 (bits 253..255 dropped), and a row that is zero there (a zero
    scalar, or bits 253..255 alone) stays a zero row, which the tiles
    skip."""
    rows = scvec.from_wide_bytes(np.random.RandomState(710).bytes(64 * 5))
    words = ck.bit_words(rows)
    if kind == "zero":
        words[:] = 0
    elif kind == "L-1":
        words[:] = ck.bit_words(scvec.from_ints([L - 1]))[0]
    elif kind == "high":
        words[:, 7] |= HIGH_BITS
    elif kind == "high only":
        words[:] = 0
        words[:, 7] = HIGH_BITS
    packed = tile_words(words)
    assert np.array_equal(cs._codes(packed.numpy(), 4, 64), bit_codes(words))
    for row, w in zip(words, packed.tolist()):
        assert cs.decode_w4(w) == _value_bits(row)
    if kind in ("zero", "high only"):
        assert not packed.ne(0).any()


# ------------------------------------------------------- the bit-word MSMs
def _bit_inputs(n: int, seed: int):
    """n generators and bit words: 0, L - 1, bits 253..255 set over a
    random scalar, and a zero row in front; a non-identity chain."""
    g = BulletproofGens(max(n, 1))
    pts = F.from_raw(g.G_raw(max(n, 1)))[:n].contiguous()
    rows = scvec.from_wide_bytes(np.random.RandomState(seed).bytes(64 * max(n, 1)))[:n]
    words = ck.bit_words(rows)
    for i, val in enumerate([0, L - 1][: n]):
        words[i] = ck.bit_words(scvec.from_ints([val]))[0]
    if n > 2:
        words[2, 7] |= HIGH_BITS
    if n > 5:
        words[5] = 0
    acc = F.from_points([PedersenGens.default().B.double()])
    return pts, torch.from_numpy(words), acc


def chunk_acc_model(points, words, acc, tile: int = 4, nb: int = 2):
    """msm_chunk_acc's order: the tiles' recode, then msm_w4's passes over
    one segment, chained on acc."""
    n = points.shape[0]
    return w4_model(points, tile_words(words.numpy()), acc, n, tile=tile, nb=nb)


@pytest.mark.parametrize("n,tile,nb", [(1, 4, 1), (4, 4, 1), (5, 4, 2), (11, 4, 2),
                                       (17, 8, 3)])
def test_chunk_acc_model_matches_plain(n, tile, nb):
    """One point, a tile exactly, one past a tile, ragged tails (11 = 2T +
    3, 17 over tiles of 8 and three blocks); chained on 2B."""
    pts, words, acc = _bit_inputs(n, 720 + n)
    got = chunk_acc_model(pts, words, acc, tile, nb)
    assert same_points(got, cc.msm_chunk_acc_plain(pts, words, acc))
    host = multiscalar_mul(
        [Scalar(_value_bits(r) % L) for r in words.tolist()] + [Scalar(1)],
        F.to_points(pts) + F.to_points(acc))
    assert F.to_points(got)[0] == host


def block_totals_model(points, words, block: int = BLOCK, tile: int = 4,
                       nb: int = 2) -> torch.Tensor:
    """msm_block_totals' order: one segment a block of `block` points (the
    last one ragged: min(block, n - s block)), the tiles' recode, pass 1
    per segment as the grid's second dimension, then lane_horner (no
    chain)."""
    n = points.shape[0]
    packed = tile_words(words.numpy())
    v = -(-n // block)
    parts = torch.stack([
        w4_partials(points, packed, min(block, n - s * block), s * block, tile, nb)
        for s in range(v)])
    return lane_horner(parts)


@pytest.mark.parametrize("n,zero_block", [(BLOCK, None), (3 * BLOCK - 5, None),
                                          (3 * BLOCK - 5, 1)])
def test_block_totals_model_matches_plain(monkeypatch, n, zero_block):
    """One block, three blocks with a ragged last one, and an all-zero
    middle block (its total the identity), at blocks of BLOCK points: the
    plain version with its block constants lowered to match, and the host
    MSM a block."""
    monkeypatch.setattr(cc, "BLOCK_PTS", BLOCK)
    monkeypatch.setattr(cc, "ORACLE_THREADS", 4)
    pts, words, _ = _bit_inputs(n, 730 + n)
    if zero_block is not None:
        words[zero_block * BLOCK : (zero_block + 1) * BLOCK] = 0
    got = block_totals_model(pts, words)
    assert got.shape == (-(-n // BLOCK), 4, 8)
    assert same_points(got, cc.msm_block_totals_plain(pts, words))
    host_pts = F.to_points(pts)
    sc = [Scalar(_value_bits(r) % L) for r in words.tolist()]
    for b, total in enumerate(F.to_points(got)):
        lo, hi = b * BLOCK, min((b + 1) * BLOCK, n)
        assert total == multiscalar_mul(sc[lo:hi], host_pts[lo:hi]), b
    if zero_block is not None:
        assert F.to_points(got)[zero_block].is_identity()


# --------------------------------------------------------------- fold_grid
def _doubled4(acc: torch.Tensor) -> torch.Tensor:
    for d in range(4):
        acc = C.point_double_limbs(acc)
        if d < 3:
            acc = no_t(acc)
    return acc


def _grid_codes(wl, wr, rows: torch.Tensor) -> list[torch.Tensor]:
    """Each scalar's (m, 65) codes for output rows `rows` (a (1, 8) word
    row is every lane's)."""
    out = []
    for w in (wl, wr):
        c = torch.from_numpy(w2_codes(w.numpy()))
        out.append(c.expand(len(rows), -1) if w.shape[0] == 1 else c[rows])
    return out


def thread_grid_model(points, wl, wr, v: int) -> torch.Tensor:
    """fold_grid's thread design: per output, the niels tables (k + 1)
    P[i] and (k + 1) P[i + v] (2P = dbl P, then t(k-1) + P); windows 64..0
    of 4 doublings (T on the 4th) once a digit was added, and each
    scalar's niels add (code 0 adds nothing)."""
    rows = torch.arange(v)
    tables = []
    for side in (points[:v], points[v : 2 * v]):
        p = F.words_to_limbs(side)
        nP = C.to_niels(p)
        e = [nP]
        x = C.point_double_limbs(p)
        e.append(C.to_niels(x))
        for _ in range(6):
            x = C.point_add_niels(x, nP)
            e.append(C.to_niels(x))
        tables.append(torch.stack(e, dim=1))
    codes = _grid_codes(wl, wr, rows)
    acc = C.identity(v, "cpu")
    started = torch.zeros(v, dtype=torch.bool)
    for pos in range(W2_WINDOWS - 1, -1, -1):
        acc = torch.where(started[:, None, None], _doubled4(acc), acc)
        for table, code in zip(tables, codes):
            c = code[:, pos]
            neg = c >= 8
            mag = torch.where(neg, 16 - c, c)
            q = C.niels_negate(table[rows, (mag - 1).clamp(min=0)], neg)
            acc = torch.where((c != 0)[:, None, None], C.point_add_niels(acc, q), acc)
            started |= c != 0
    return F.limbs_to_words(acc)


def group_grid_model(points, wl, wr, v: int) -> torch.Tensor:
    """fold_grid's group design: groups past v repeat output v - 1,
    fold_bits' niels tables of P[i] and P[i + v], the warp's 65 windows (a
    doubling once any group added, a scalar's add when any group's digit
    is nonzero, the identity for the others)."""
    pad = -v % WARP
    idx = torch.cat([torch.arange(v), torch.full((pad,), v - 1)])
    m = idx.numel()
    warp = torch.arange(m) // WARP
    tables = [niels_tables(F.words_to_limbs(points[:v][idx])),
              niels_tables(F.words_to_limbs(points[v : 2 * v][idx]))]
    codes = _grid_codes(wl, wr, idx)
    ident = C.to_niels(C.identity(m, "cpu"))
    acc = C.identity(m, "cpu")
    started = torch.zeros(m // WARP, dtype=torch.bool)
    lanes = torch.arange(m)
    for win in range(W2_WINDOWS - 1, -1, -1):
        acc = torch.where(started[warp][:, None, None], _doubled4(acc), acc)
        for table, code in zip(tables, codes):
            c = code[:, win]
            need = (c != 0).view(-1, WARP).any(dim=1)
            neg = c >= 8
            mag = torch.where(neg, 16 - c, c)
            q = C.niels_negate(table[lanes, (mag - 1).clamp(min=0)], neg)
            q = torch.where((c != 0)[:, None, None], q, ident)
            acc = torch.where(need[warp][:, None, None], C.point_add_niels(acc, q), acc)
            started |= need
    return F.limbs_to_words(acc)[:v]


GRID_MODELS = {"thread": thread_grid_model, "group": group_grid_model}


def _grid_words(kind: str, v: int, seed: int):
    """(wl, wr): per-lane w2 rows of random scalars with the edge rows 0,
    1, L - 1 and all -2 digits in front (``lanes``), or the constant rows
    (L - 1, 1), (0, all -2 digits) or random (``const*``)."""
    rng = np.random.RandomState(seed)
    if kind == "lanes":
        sl = scvec.from_wide_bytes(rng.bytes(64 * v))
        sr = scvec.from_wide_bytes(rng.bytes(64 * v))
        k = min(3, v)
        sl[:k] = scvec.from_ints([0, 1, L - 1][:k])
        sr[:k] = scvec.from_ints([L - 1, 0, 1][:k])
        wl, wr = ck.signed_digit2_words(sl), ck.signed_digit2_words(sr)
        if v > 3:
            wl[3] = wr[3] = ALL_M2
        return torch.from_numpy(wl), torch.from_numpy(wr)
    if kind == "const edge":
        return (ck.const_grid_words(Scalar(L - 1), "cpu"),
                ck.const_grid_words(Scalar(1), "cpu"))
    if kind == "const zero, all -2":
        return (ck.const_grid_words(Scalar(0), "cpu"),
                torch.full((1, 8), ALL_M2, dtype=torch.int32))
    c = Scalar(int.from_bytes(rng.bytes(32), "little") % L)
    return ck.const_grid_words(c.invert(), "cpu"), ck.const_grid_words(c, "cpu")


@pytest.mark.parametrize("design", sorted(GRID_MODELS))
@pytest.mark.parametrize("kind", ["lanes", "const edge", "const zero, all -2",
                                  "const random"])
@pytest.mark.parametrize("v", [1, 3, 17])
def test_fold_grid_model_matches_plain(design, kind, v):
    """Both designs at v = 1 (three dummy groups), 3 and 17 (a ragged last
    warp), per-lane words with the edge scalars and constant rows (a row
    read by every lane), into points at N > 2v (rows past 2v unread)."""
    pts = F.from_raw(BulletproofGens(2 * v + 1).G_raw(2 * v + 1))
    wl, wr = _grid_words(kind, v, 740 + v)
    got = GRID_MODELS[design](pts, wl, wr, v)
    assert same_points(got, cc.fold_grid_plain(pts, wl, wr, v))


def test_fold_grid_model_matches_host():
    """The thread design's order against the host group law on the edge
    lanes: wl_i P[i] + wr_i P[i + v] (the all -2 row's negative value
    taken mod L: Ristretto points compare as group elements)."""
    v = 4
    pts = F.from_raw(BulletproofGens(2 * v).G_raw(2 * v))
    wl, wr = _grid_words("lanes", v, 750)
    got = F.to_points(thread_grid_model(pts, wl, wr, v))
    host = F.to_points(pts)
    for i in range(v):
        a, b = _value_w2(wl[i].tolist()), _value_w2(wr[i].tolist())
        want = host[i].scalar_mul(Scalar(a % L)) + host[i + v].scalar_mul(Scalar(b % L))
        assert got[i] == want, i


def test_fold_grid_design_names():
    """The wrapper's design names: None lets the library choose; anything
    else is refused before any launch."""
    assert cc._design_number("fold_grid", cc.FOLD_GRID_DESIGNS, None) == -1
    assert [cc._design_number("fold_grid", cc.FOLD_GRID_DESIGNS, d)
            for d in cc.FOLD_GRID_DESIGNS] == [0, 1]
    pts = F.identity_points(4)
    w = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        cc.fold_grid(pts, w, w, 2, design="ladder")
