"""The operation orders of the windowed w4 MSM and the niels-table fold,
on the CPU.

The second versions of ``msm_w4`` / ``msm_w4_pair`` (``csrc/win.cu``:
tiles of points with their eight multiples in niels form, per-window sums
in two halves, the blocks' partials, then Horner with the accumulator
last) and of ``fold_w3h`` / ``fold_w3h_comb`` (``csrc/fold_w3h.cu``: two
4-entry niels tables, the first two doublings of each window without T)
compute in another order than the kernels' plain versions.  These tests
model each kernel's order in torch, step for step at small sizes, and
hold it against the plain versions (``ops/cuda_curve.py``) as group
elements, before any card run: the tables' addition chains (5P = 4P + P,
7P = 6P + P, 3P = 2P + P), the signed digits (all -8 / all -4 rows, zero
rows, L - 1), segments that end inside a tile, and T left out of the
doublings that feed a doubling (the model zeroes it there, so a doubling
that read T would show).

Tolerance: exact (the same Edwards point: X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1).
"""

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu_torch import BulletproofGens, L, PedersenGens, scvec
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import curve as C
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F

torch.set_num_threads(1)

WINDOWS = cc.W4_WINDOWS
ALL_M8 = -0x77777778  # 0x88888888: eight digits of -8
ALL_M4 = 0x44444444  # code 4 in every nibble: w3h digits of -4


def same_points(a: torch.Tensor, b: torch.Tensor) -> bool:
    """(n, 4, 8) words: every pair the same Edwards point."""
    x, y = F.words_to_limbs(a), F.words_to_limbs(b)
    for c in (0, 1):
        lhs = F.canonical(F.mul(x[:, c], y[:, 2]))
        rhs = F.canonical(F.mul(y[:, c], x[:, 2]))
        if not torch.equal(lhs, rhs):
            return False
    return True


def no_t(p: torch.Tensor) -> torch.Tensor:
    """A doubling's output with T left out, as the kernels' T-free
    doublings leave it (0)."""
    p = p.clone()
    p[..., 3, :] = 0
    return p


def _code(words: torch.Tensor, win) -> torch.Tensor:
    """Nibble `win` of (m, 8) word rows: an int gives (m,), an (m, k)
    tensor of windows (m, k)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    win = torch.as_tensor(win)
    if win.dim() == 0:
        return (w[:, win // 8] >> (4 * (win % 8))) & 15
    return (torch.gather(w, 1, win // 8) >> (4 * (win % 8))) & 15


def w4_table(p: torch.Tensor) -> torch.Tensor:
    """(m, 4, 16) limbs -> (m, 8, 4, 16) niels entries (k + 1) P by the
    kernel's two table threads: role 1 P, 3P = 2P + P, 6P, 7P = 6P + P;
    role 0 2P, 4P, 5P = 4P + P, 8P."""
    nP = C.to_niels(p)
    e = [None] * 8
    e[0] = nP
    x = C.point_add_niels(C.point_double_limbs(p), nP)
    e[2] = C.to_niels(x)
    x = C.point_double_limbs(x)
    e[5] = C.to_niels(x)
    e[6] = C.to_niels(C.point_add_niels(x, nP))
    x = C.point_double_limbs(p)
    e[1] = C.to_niels(x)
    x = C.point_double_limbs(x)
    e[3] = C.to_niels(x)
    e[4] = C.to_niels(C.point_add_niels(x, nP))
    e[7] = C.to_niels(C.point_double_limbs(x))
    return torch.stack(e, dim=1)


def w4_partials(points, words, n: int, off: int, tile: int, nb: int):
    """(nb, 64, 4, 16): pass 1 over the segment of n points at `off`: block
    b takes tiles b, b + nb, ...; per tile, half h of the block's threads
    adds, for each window, the selected entries of points h * tile / 2 ..
    (h + 1) * tile / 2 - 1 (nothing for code 0); then the halves' sums."""
    parts = []
    tiles = -(-n // tile)
    for b in range(nb):
        acc = C.identity(2 * WINDOWS, "cpu").view(2, WINDOWS, 4, F.NLIMBS)
        for t in range(b, tiles, nb):
            lo = off + t * tile
            cnt = min(tile, n - t * tile)
            w = torch.zeros((tile, 8), dtype=torch.int32)
            w[:cnt] = words[lo : lo + cnt]
            tbl = torch.zeros((tile, 8, 4, F.NLIMBS), dtype=torch.int64)
            live = w.ne(0).any(dim=1)
            if live.any():
                rows = torch.nonzero(live).flatten()
                tbl[rows] = w4_table(F.words_to_limbs(points[lo + rows]))
            for i in range(tile // 2):
                p = torch.tensor([i, tile // 2 + i])  # the two halves' points
                e = _code(w[p], torch.arange(WINDOWS).expand(2, WINDOWS))
                neg = e >= 8
                mag = torch.where(neg, 16 - e, e)
                q = tbl[p[:, None], (mag - 1).clamp(min=0)]
                nxt = C.point_add_niels(acc, C.niels_negate(q, neg))
                acc = torch.where((e != 0)[..., None, None], nxt, acc)
        parts.append(C.point_add_limbs(acc[0], acc[1]))
    return torch.stack(parts)


def horner(parts: torch.Tensor, chain: torch.Tensor) -> torch.Tensor:
    """Passes 2-3: each window's partials summed into niels form, then
    Horner from the top window (4 doublings between windows, T only on
    the last), the chain (1, 4, 8) added last."""
    tot = C.to_niels(C.block_reduce(parts.transpose(0, 1))[:, 0])  # (64, 4, 16)
    acc = C.identity(1, "cpu")
    for win in range(WINDOWS - 1, -1, -1):
        if win < WINDOWS - 1:
            for d in range(4):
                acc = C.point_double_limbs(acc)
                if d < 3:
                    acc = no_t(acc)
        acc = C.point_add_niels(acc, tot[win : win + 1])
    acc = C.point_add_niels(acc, C.to_niels(F.words_to_limbs(chain)))
    return F.limbs_to_words(acc)


def w4_model(points, words, acc, n, off=0, tile=4, nb=2):
    return horner(w4_partials(points, words, n, off, tile, nb), acc)


def _msm_inputs(n: int, seed: int):
    pts = F.from_raw(BulletproofGens(max(n, 1)).G_raw(max(n, 1)))[:n]
    rows = scvec.from_wide_bytes(np.random.RandomState(seed).bytes(64 * n))
    words = torch.from_numpy(ck.signed_digit_words(rows)).contiguous()
    edges = {1: ALL_M8, 2: 0, 4: ALL_M8}  # all -8 digits, a zero row
    for i, val in edges.items():
        if i < n:
            words[i] = val
    if n > 3:
        words[3] = torch.from_numpy(ck.signed_digit_words(scvec.from_ints([L - 1])))[0]
    acc = F.from_points([PedersenGens.default().B.double()])
    return pts.contiguous(), words, acc


@pytest.mark.parametrize("n,tile,nb", [
    (0, 4, 1), (1, 4, 1), (3, 4, 2), (4, 4, 1), (5, 4, 2), (17, 4, 2),
    (17, 8, 3), (20, 4, 8),
])
def test_windowed_msm_model_matches_plain(n, tile, nb):
    """msm_w4's windowed order at n points around a tile of `tile` (0, 1,
    T - 1, T, T + 1, 3T + 5 at T = 4; more blocks than tiles; 3 tiles over
    2 blocks), with all -8 rows, a zero row and L - 1, chained on 2B."""
    pts, words, acc = _msm_inputs(n, 300 + n)
    got = w4_model(pts, words, acc, n, tile=tile, nb=nb)
    assert same_points(got, cc.msm_w4_plain(pts, words, acc))


@pytest.mark.parametrize("lo,hi", [(0, 9), (9, 0), (9, 9), (7, 3), (0, 0)])
def test_windowed_pair_model_matches_plain(lo, hi):
    """msm_w4_pair's two segments [0, lo) and [half, half + hi) as the
    grid's second dimension (the blocks sized by the larger one), each
    with its own accumulator: one limit 0, equal and unequal limits."""
    half = 9
    pts, words, _ = _msm_inputs(2 * half, 310)
    acc2 = F.from_points([PedersenGens.default().B,
                          PedersenGens.default().B.double()])
    tile, nb = 4, max(1, -(-max(lo, hi) // 4) // 2)
    got = torch.cat([
        horner(w4_partials(pts, words, lo, 0, tile, nb), acc2[0:1]),
        horner(w4_partials(pts, words, hi, half, tile, nb), acc2[1:2]),
    ])
    assert same_points(got, cc.msm_w4_pair_plain(pts, words, acc2, half, lo, hi))


def test_w4_table_holds_the_multiples():
    """Entry k of the two threads' table is (k + 1) P for points whose T is
    non-trivial."""
    p = F.words_to_limbs(F.from_raw(BulletproofGens(3).G_raw(3)))
    tbl = w4_table(p)
    ident = C.identity(3, "cpu")
    mult = p
    for k in range(8):
        got = F.limbs_to_words(C.point_add_niels(ident, tbl[:, k]))
        assert same_points(got, F.limbs_to_words(mult)), k
        mult = C.point_add_limbs(mult, p)


def fold_model(points, words, bp: int) -> torch.Tensor:
    """One side of fold_w3h in the kernel's order: niels tables (P, 2P,
    3P = 2P + P, 4P) of P[i] and P[i + v], then per window from the top:
    3 doublings once a digit was added (T only on the third), beta's
    digit on P[i]'s table, alpha's on P[i + v]'s (code 4: entry 4
    negated; code 0 adds nothing)."""
    v = points.shape[0] // 2
    rows = torch.arange(v)
    tables = []
    for s in range(2):
        p = F.words_to_limbs(points[s * v : (s + 1) * v])
        nP = C.to_niels(p)
        x = C.point_double_limbs(p)
        tables.append(torch.stack([
            nP, C.to_niels(x), C.to_niels(C.point_add_niels(x, nP)),
            C.to_niels(C.point_double_limbs(x)),
        ], dim=1))
    pair = (rows >= bp).long()
    digit_words = (words[pair, 0], words[pair, 1])  # beta, alpha
    acc = C.identity(v, "cpu")
    started = torch.zeros(v, dtype=torch.bool)
    for pos in range(cc.W3H_DIGITS - 1, -1, -1):
        dbl = acc
        for d in range(3):
            dbl = C.point_double_limbs(dbl)
            if d < 2:
                dbl = no_t(dbl)
        acc = torch.where(started[:, None, None], dbl, acc)
        for table, w in zip(tables, digit_words):
            code = _code(w, pos) & 7
            neg = code >= 4
            mag = torch.where(neg, 8 - code, code)
            q = C.niels_negate(table[rows, (mag - 1).clamp(min=0)], neg)
            nxt = C.point_add_niels(acc, q)
            acc = torch.where((mag != 0)[:, None, None], nxt, acc)
            started |= mag != 0
    return F.limbs_to_words(acc)


def _fold_pairs(kind: str, rng):
    if kind == "random":
        return [ck.half_gcd_split(int.from_bytes(rng.bytes(32), "little") % L, L)
                for _ in range(2)]
    return [(0, 1), (1, -1)]


@pytest.mark.parametrize("kind", ["random", "edge"])
@pytest.mark.parametrize("v,bp", [(1, 0), (1, 1), (5, 2), (6, 6), (6, 0)])
def test_fold_model_matches_plain(kind, v, bp):
    """fold_w3h's order on random half-gcd pairs and the edge pairs (0, 1)
    / (1, -1), v = 1 and small v, bp at 0, inside and at v."""
    rng = np.random.RandomState(320 + v + bp)
    pts = F.from_raw(BulletproofGens(2 * v).G_raw(2 * v))
    words = ck.w3h_fold_words([_fold_pairs(kind, rng)], "cpu")
    got = fold_model(pts, words[0], bp)
    assert same_points(got, cc.fold_w3h_plain(pts, words, bp))


def test_fold_model_all_minus_four_digits_matches_plain():
    """Rows of all -4 digits (code 4: entry 4 negated) on both scalars of
    one pair, and of both pairs' alpha."""
    v = 4
    pts = F.from_raw(BulletproofGens(2 * v).G_raw(2 * v))
    words = ck.w3h_fold_words([_fold_pairs("random", np.random.RandomState(330))],
                              "cpu")
    words[0, 0] = ALL_M4
    words[0, 1, 1] = ALL_M4
    got = fold_model(pts, words[0], 2)
    assert same_points(got, cc.fold_w3h_plain(pts, words, 2))


def test_fold_comb_model_matches_plain():
    """fold_w3h_comb is the kernel's two sides, each with its own words."""
    v = 3
    pts = F.from_raw(BulletproofGens(4 * v).G_raw(4 * v))
    rng = np.random.RandomState(340)
    words = ck.w3h_fold_words([_fold_pairs("random", rng), _fold_pairs("edge", rng)],
                              "cpu")
    got = torch.cat([fold_model(pts[s * 2 * v : (s + 1) * 2 * v], words[s], 1)
                     for s in range(2)])
    assert same_points(got, cc.fold_w3h_comb_plain(pts, words, 1))
