"""The orders of the cooperative ``fold_bits`` and the two-role niels
tables, on the CPU.

``fold_bits`` (``csrc/msm_fold.cu``) recodes each scalar's bits 252..0
into 64 signed base-16 digits (the top digit takes the carry), builds an
8-entry niels table of L and one of R, and runs Straus over 64 windows
with zero digits skipped: a group of 8 lanes per output, four outputs a
warp, and the warp takes a doubling or an add when any of its groups
needs one (a group with digit 0 adds the identity).  ``table_w4`` /
``table_w5`` (``csrc/win.cu``) split the TPU kernels' table sequence
over two threads a point by the schedule ``TBL_SCHED``, which these
tests read from the CUDA source (the w4 MSM's tile tables run the same
steps).

Each model runs in torch, step for step at small sizes, and is held
against the kernels' plain versions (``ops/cuda_curve.py``): the fold
as group elements (tolerance: exact, X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1)
and against the JAX package's exact host mirror ``sim_fold_chunk``
(tests/test_ipp_factor_fold.py), the tables byte for byte (canonical
words).  Edge rows: both scalars zero, wl = 1, wl = L - 1, every nibble
8, and bits 253-255 set (which must be ignored).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import multiscalar_mul
from bulletproofs_r1cs_gadgets_tpu_torch import BulletproofGens, L, scvec
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import curve as C
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F
from test_ipp_factor_fold import sim_fold_chunk
from test_torch_kernels import (
    _chunk_points,
    _chunk_words,
    _jax_lane_point,
    _points,
    _scalar_rows,
    to_points,
)
from test_torch_ladder import no_t, same_points

torch.set_num_threads(1)

CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "bulletproofs_r1cs_gadgets_tpu_torch" / "csrc")
WARP = 4  # outputs a warp: 8 lanes each
ALL_8 = -0x77777778  # 0x88888888: every nibble 8
HIGH_BITS = -0x20000000  # 0xe0000000: bits 253..255 of word 7


# ------------------------------------------------------------ fold_bits
def recode(words: torch.Tensor) -> torch.Tensor:
    """(m, 8) raw bit words -> (m, 64) signed base-16 digit codes of bits
    252..0 (code d & 15, d = code - 16 for code >= 8), as fold_recode:
    chip_smoke's, which also counts the kernel's bound."""
    return torch.from_numpy(cs.fold_codes(words.numpy()))


def niels_tables(p: torch.Tensor) -> torch.Tensor:
    """(m, 4, 16) limbs -> (m, 8, 4, 16) niels entries (k + 1) P, made in
    extended form (entry k odd: a doubling of entry (k - 1) / 2; even: entry
    k - 1 + P) and then turned into niels form."""
    nP = C.to_niels(p)
    e = [p]
    for k in range(1, 8):
        e.append(C.point_double_limbs(e[(k - 1) // 2]) if k & 1
                 else C.point_add_niels(e[k - 1], nP))
    return C.to_niels(torch.stack(e, dim=1))


def fold_model(left, right, wl, wr) -> torch.Tensor:
    """fold_bits in the kernel's order: groups past n repeat row n - 1, a
    warp of WARP outputs doubles once any of its groups added, and takes
    each scalar's add when any of its groups has a nonzero digit (the
    others add the identity); 4 doublings a window, T on the last."""
    n = left.shape[0]
    pad = -n % WARP
    rows = torch.cat([torch.arange(n), torch.full((pad,), n - 1)])
    m = rows.numel()
    warp = torch.arange(m) // WARP
    codes = (recode(wl[rows]), recode(wr[rows]))
    tables = (niels_tables(F.words_to_limbs(left[rows])),
              niels_tables(F.words_to_limbs(right[rows])))
    ident = C.to_niels(C.identity(m, "cpu"))
    acc = C.identity(m, "cpu")
    started = torch.zeros(m // WARP, dtype=torch.bool)
    idx = torch.arange(m)
    for win in range(63, -1, -1):
        dbl = acc
        for d in range(4):
            dbl = C.point_double_limbs(dbl)
            if d < 3:
                dbl = no_t(dbl)
        acc = torch.where(started[warp][:, None, None], dbl, acc)
        for table, code in zip(tables, codes):
            c = code[:, win]
            need = (c != 0).view(-1, WARP).any(dim=1)
            neg = c >= 8
            mag = torch.where(neg, 16 - c, c)
            q = C.niels_negate(table[idx, (mag - 1).clamp(min=0)], neg)
            q = torch.where((c != 0)[:, None, None], q, ident)
            acc = torch.where(need[warp][:, None, None], C.point_add_niels(acc, q), acc)
            started |= need
    return F.limbs_to_words(acc)[:n]


def _fold_rows(n: int, seed: int, kind: str):
    """Raw bit words (wl, wr) for n lanes: random right scalars and ones
    on the left as the IPP folds use (``ipp``) or random left scalars
    (``random``), with the edge rows in front."""
    sl = (scvec.from_ints([1] * n) if kind == "ipp"
          else _scalar_rows(n, seed))
    sr = _scalar_rows(n, seed + 1)
    wl, wr = ck.bit_words(sl), ck.bit_words(sr)
    edges = [
        (0, 0),                                  # both scalars zero
        (1, None),                               # wl = 1
        (L - 1, None),                           # wl = L - 1
        (None, 0),                               # wr = 0
        ("all8", "all8"),                        # every nibble 8
        ("high", "high"),                        # bits 253..255 set
    ]
    for i, pair in enumerate(edges[: n]):
        for w, val in zip((wl, wr), pair):
            if val == "all8":
                w[i] = ALL_8
            elif val == "high":
                w[i, 7] |= HIGH_BITS
            elif val is not None:
                w[i] = ck.bit_words(scvec.from_ints([val]))[0]
    return torch.from_numpy(wl), torch.from_numpy(wr)


def _value(row) -> int:
    return sum((int(v) & 0xFFFFFFFF) << (32 * j) for j, v in enumerate(row))


@pytest.mark.parametrize("kind", ["random", "zero", "one", "L-1", "all8", "high"])
def test_recode_digits_hold_bits_252_to_0(kind):
    """The recoded digits sum to bits 252..0 of the word (bits 253..255
    dropped), each in [-8, 7], the top one <= 2 (it takes the carry)."""
    rows = _scalar_rows(8, 401)
    w = ck.bit_words(rows)
    if kind == "zero":
        w[:] = 0
    elif kind == "one":
        w[:] = ck.bit_words(scvec.from_ints([1]))[0]
    elif kind == "L-1":
        w[:] = ck.bit_words(scvec.from_ints([L - 1]))[0]
    elif kind == "all8":
        w[:] = ALL_8
    elif kind == "high":
        w[:, 7] |= HIGH_BITS
    codes = recode(torch.from_numpy(w))
    digits = torch.where(codes >= 8, codes - 16, codes)
    assert int(digits[:, 63].max()) <= 2
    for row, d in zip(w, digits.tolist()):
        assert sum(x << (4 * j) for j, x in enumerate(d)) == _value(row) % (1 << 253)


@pytest.mark.parametrize("n,kind", [
    (1, "ipp"), (6, "random"), (6, "ipp"), (9, "random"), (13, "ipp"),
])
def test_fold_model_matches_plain(n, kind):
    """The cooperative order at n lanes around a warp of four outputs (1:
    three dummy groups; 9, 13: a ragged last warp), edge rows in front."""
    g = BulletproofGens(2 * n)
    left, right = F.from_raw(g.G_raw(2 * n))[:n], F.from_raw(g.H_raw(2 * n))[:n]
    wl, wr = _fold_rows(n, 410 + n, kind)
    got = fold_model(left, right, wl, wr)
    assert same_points(got, cc.fold_bits_plain(left, right, wl, wr))
    if n > 1:
        assert same_points(got[:1], F.identity_points(1))  # both scalars zero


@pytest.mark.parametrize("kind", ["random", "ipp"])
def test_fold_model_matches_tpu_mirror(kind):
    """The model against the JAX package's host mirror of fold_chunk and
    the host MSM, lane for lane, in the TPU's chunk layout.  The mirror
    reads every raw bit, so bits 253..255 are cleared here (the all-8 row
    keeps its nibbles below)."""
    n = 10
    left, right = _points(n, 420), _points(n, 421)
    lchunk, lflat = _chunk_points(left)
    rchunk, rflat = _chunk_points(right)
    wl, wr = _fold_rows(n, 422, kind)
    wl[:, 7] &= 0x1FFFFFFF
    wr[:, 7] &= 0x1FFFFFFF
    out = np.asarray(sim_fold_chunk(lchunk, rchunk, _chunk_words(wl.numpy()),
                                    _chunk_words(wr.numpy())))
    got = to_points(fold_model(lflat[:n].contiguous(), rflat[:n].contiguous(), wl, wr))
    for i in range(n):
        assert got[i] == _jax_lane_point(out, i)
        sc = scvec.to_scalars(np.stack([
            scvec.from_ints([_value(wl[i]) % L])[0],
            scvec.from_ints([_value(wr[i]) % L])[0],
        ]))
        assert got[i] == multiscalar_mul(sc, [left[i], right[i]])


# ------------------------------------------------------------- the tables
def table_schedule() -> list[list[tuple[int, bool, str]]]:
    """TBL_SCHED of csrc/win.cu: per role, per step (entry, add, keep) with
    keep one of "x", "save", "drop", "back"."""
    text = (CSRC / "win.cu").read_text()
    flags = {m.group(1): int(m.group(2), 16) for m in re.finditer(
        r"#define (T_\w+) (0x[0-9a-f]+)u", text)}
    body = re.search(r"TBL_SCHED\[2\]\[8\] = \{(.*?)\};", text, re.S).group(1)
    roles = re.findall(r"\{([^{}]*)\}", body)
    keep = {0: "x", flags["T_SAVE"]: "save", flags["T_DROP"]: "drop",
            flags["T_BACK"]: "back"}
    sched = []
    for role in roles:
        steps = []
        for item in role.split(","):
            val = 0
            for tok in item.split("|"):
                tok = tok.strip()
                val |= flags[tok] if tok in flags else int(tok)
            steps.append((val & 15, bool(val & flags["T_ADD"]),
                          keep[val & flags["T_KEEP_MASK"]]))
        sched.append(steps)
    return sched


def table_model(points: torch.Tensor, entries: int) -> torch.Tensor:
    """(n, entries, 4, 8) canonical niels words by the two roles of the
    table kernel: each runs entries / 2 steps of TBL_SCHED on its point x
    (a doubling, or an add of P in niels form), stores the step's entry
    (role 1's first step stores P) and keeps x, one saved point, or
    neither."""
    p = F.words_to_limbs(points)
    nP = C.to_niels(p)
    out = [None] * entries
    for role, steps in enumerate(table_schedule()):
        x = saved = p
        for k, (entry, add, keep) in enumerate(steps[: entries // 2]):
            y = C.point_add_niels(x, nP) if add else C.point_double_limbs(x)
            out[entry] = nP if role == 1 and k == 0 else C.to_niels(y)
            if keep == "x":
                x = y
            elif keep == "save":
                saved = y
            elif keep == "back":
                x = saved
    assert all(e is not None for e in out)
    return F.limbs_to_words(torch.stack(out, dim=1))


@pytest.mark.parametrize("entries,n", [(8, 1), (8, 37), (16, 1), (16, 37)])
def test_table_model_matches_plain_bytes(entries, n):
    """The two-role schedule gives table_w4_plain's / table_w5_plain's
    canonical words exactly, and the 8-entry table is the 16-entry one's
    first half."""
    pts = F.from_raw(BulletproofGens(n).G_raw(n))
    got = table_model(pts, entries)
    plain = cc.table_w4_plain(pts) if entries == 8 else cc.table_w5_plain(pts)
    assert torch.equal(got, plain)
    if entries == 8:
        assert torch.equal(got, cc.table_w5_plain(pts)[:, :8])


@pytest.mark.parametrize("entries", [8, 16])
def test_table_schedule_covers_each_entry_once(entries):
    """Each role's first entries / 2 steps store distinct entries, together
    every one of 0 .. entries - 1, and no step reads a point it has not
    made (a "back" follows a "save")."""
    sched = table_schedule()
    stored = [e for steps in sched for e, _, _ in steps[: entries // 2]]
    assert sorted(stored) == list(range(entries))
    for steps in sched:
        kept = [keep for _, _, keep in steps[: entries // 2]]
        for k, keep in enumerate(kept):
            if keep == "back":
                assert "save" in kept[:k]
