"""The operation orders of the windowed ``msm_lane`` and of the two
constant-fold designs, on the CPU; and the host library's name.

``msm_lane`` (``csrc/win.cu``) runs the windowed w4 MSM's passes over v
segments of ``seg`` points: the first pass's tiles per segment, then one
Horner walk a segment with no chain (each total starts from the
identity).  ``fold_c`` / ``fold_c_comb`` (``csrc/msm_fold.cu``) compute
out[i] = P[i] + c_i * P[i + v] by Straus over an 8-entry niels table of
P[i + v] and the constant's signed base-16 digits, in two designs:

* ``thread``: one thread an output; table 2P = dbl P, then t(k-1) + P;
  64 windows of 4 doublings (T only on the 4th) once a digit was added,
  then P[i] in niels form as a last add with no doublings;
* ``group``: ``fold_bits``' cooperative table (2P = dbl P, odd multiples
  t(k-1) + P, even ones doubled) and window loop, four outputs a warp
  (groups past v repeat output v - 1); the warp doubles once any of its
  groups added and takes an add when any has a nonzero digit (the others
  add the identity); then P[i] added in niels form.

Each model runs in torch, step for step at small sizes, with T zeroed
where the kernels leave it out (``no_t``), and is held against the
kernels' plain versions (``ops/cuda_curve.py``) as group elements.
Edge cases: v = 1, 3 and 16 segments, a segment ending inside a tile, an
all-zero segment, identity points; constants 0, 1 and L - 1, all -8
digits; breakpoints at 0, inside a warp and at v.

Tolerance: exact (the same Edwards point: X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1).
"""

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu_torch import BulletproofGens, L, Scalar, scvec
from bulletproofs_r1cs_gadgets_tpu_torch.native import loader
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import curve as C
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F
from test_torch_fold_bits import niels_tables
from test_torch_ladder import ALL_M8, _code, no_t, same_points, w4_partials

torch.set_num_threads(1)

WINDOWS = cc.W4_WINDOWS
WARP = 4  # fold_c's group design: outputs a warp, 8 lanes each


# ------------------------------------------------------------- msm_lane
def lane_horner(parts: torch.Tensor) -> torch.Tensor:
    """(v, nb, 64, 4, 16) partials -> (v, 4, 8): pass 2 per segment and
    window, then Horner per segment from the top window (4 doublings
    between windows, T only on the last), no chain."""
    v = parts.shape[0]
    tot = C.to_niels(C.block_reduce(parts.transpose(1, 2).reshape(
        v * WINDOWS, -1, 4, F.NLIMBS))[:, 0]).view(v, WINDOWS, 4, F.NLIMBS)
    acc = C.identity(v, "cpu")
    for win in range(WINDOWS - 1, -1, -1):
        if win < WINDOWS - 1:
            for d in range(4):
                acc = C.point_double_limbs(acc)
                if d < 3:
                    acc = no_t(acc)
        acc = C.point_add_niels(acc, tot[:, win])
    return F.limbs_to_words(acc)


def lane_model(points, words, v: int, tile: int = 4, nb: int = 2) -> torch.Tensor:
    """msm_lane's order: pass 1 over segment s = rows [s * seg, (s + 1) *
    seg) as the grid's second dimension (every segment the same blocks),
    then lane_horner."""
    seg = points.shape[0] // v
    parts = torch.stack([w4_partials(points, words, seg, s * seg, tile, nb)
                         for s in range(v)])
    return lane_horner(parts)


def _lane_inputs(v: int, seg: int, seed: int):
    """v segments of seg generators with random w4 words; rows 0, 1, 2 of
    the first segment 0, 1, L - 1, row 3 all -8 digits; the last segment's
    last two rows identity points (one with a zero word, one not)."""
    n = v * seg
    pts = F.from_raw(BulletproofGens(n).G_raw(n)).clone()
    rows = scvec.from_wide_bytes(np.random.RandomState(seed).bytes(64 * n))
    rows[: min(3, n)] = scvec.from_ints([0, 1, L - 1][: min(3, n)])
    words = torch.from_numpy(ck.signed_digit_words(rows)).contiguous()
    if n > 3:
        words[3] = ALL_M8
    if seg > 2:
        pts[n - 2 :] = F.identity_points(2)
        words[n - 1] = 0
    return pts.contiguous(), words


@pytest.mark.parametrize("v,seg,nb", [(1, 5, 1), (3, 5, 2), (3, 9, 1), (16, 3, 1)])
def test_lane_model_matches_plain(v, seg, nb):
    """v = 1, 3 and 16 segments; seg 5 and 9 end inside a 4-point tile,
    seg 3 inside its first; one or two blocks a segment."""
    pts, words = _lane_inputs(v, seg, 500 + v * seg)
    got = lane_model(pts, words, v, nb=nb)
    assert same_points(got, cc.msm_lane_plain(pts, words, v))


def test_lane_model_all_zero_segment_is_identity():
    """A segment of zero words sums to the identity (no table, no add;
    Horner over identity totals)."""
    v, seg = 3, 5
    pts, words = _lane_inputs(v, seg, 510)
    words[seg : 2 * seg] = 0
    got = lane_model(pts, words, v)
    assert same_points(got, cc.msm_lane_plain(pts, words, v))
    assert same_points(got[1:2], F.identity_points(1))


# --------------------------------------------------------------- fold_c
def _signed(codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(negative, magnitude) of signed base-16 digit codes (code 8: -8)."""
    neg = codes >= 8
    return neg, torch.where(neg, 16 - codes, codes)


def _const_codes(words: torch.Tensor, idx: torch.Tensor, bp: int) -> torch.Tensor:
    """(m, 64) digit codes of output idx's constant: words[0] below bp,
    words[1] from bp on."""
    w = words[(idx >= bp).long()]
    return _code(w, torch.arange(WINDOWS).expand(len(idx), WINDOWS))


def thread_fold_model(points, words, bp: int) -> torch.Tensor:
    """One side of fold_c's thread design: per output, the niels table
    (k + 1) P[i + v] (2P = dbl P, then t(k-1) + P) and P[i]; windows
    63..0 of 4 doublings (T on the 4th) once a digit was added and the
    digit's niels add (code 0 adds nothing); then P[i] with no
    doublings."""
    v = points.shape[0] // 2
    rows = torch.arange(v)
    p = F.words_to_limbs(points[v:])
    nP = C.to_niels(p)
    e = [nP]
    x = C.point_double_limbs(p)
    e.append(C.to_niels(x))
    for _ in range(6):
        x = C.point_add_niels(x, nP)
        e.append(C.to_niels(x))
    table = torch.stack(e, dim=1)
    codes = _const_codes(words, rows, bp)
    acc = C.identity(v, "cpu")
    started = torch.zeros(v, dtype=torch.bool)
    for pos in range(WINDOWS - 1, -1, -1):
        dbl = acc
        for d in range(4):
            dbl = C.point_double_limbs(dbl)
            if d < 3:
                dbl = no_t(dbl)
        acc = torch.where(started[:, None, None], dbl, acc)
        neg, mag = _signed(codes[:, pos])
        q = C.niels_negate(table[rows, (mag - 1).clamp(min=0)], neg)
        acc = torch.where((mag != 0)[:, None, None], C.point_add_niels(acc, q), acc)
        started |= mag != 0
    acc = C.point_add_niels(acc, C.to_niels(F.words_to_limbs(points[:v])))
    return F.limbs_to_words(acc)


def group_fold_model(points, words, bp: int) -> torch.Tensor:
    """One side of fold_c's group design: groups past v repeat output
    v - 1, fold_bits' niels table of P[i + v], the warp's windows (a
    doubling once any group added, an add when any group's digit is
    nonzero, the identity for the others), then P[i] in niels form."""
    v = points.shape[0] // 2
    pad = -v % WARP
    idx = torch.cat([torch.arange(v), torch.full((pad,), v - 1)])
    m = idx.numel()
    warp = torch.arange(m) // WARP
    table = niels_tables(F.words_to_limbs(points[v:][idx]))
    codes = _const_codes(words, idx, bp)
    ident = C.to_niels(C.identity(m, "cpu"))
    acc = C.identity(m, "cpu")
    started = torch.zeros(m // WARP, dtype=torch.bool)
    lanes = torch.arange(m)
    for win in range(WINDOWS - 1, -1, -1):
        dbl = acc
        for d in range(4):
            dbl = C.point_double_limbs(dbl)
            if d < 3:
                dbl = no_t(dbl)
        acc = torch.where(started[warp][:, None, None], dbl, acc)
        c = codes[:, win]
        need = (c != 0).view(-1, WARP).any(dim=1)
        neg, mag = _signed(c)
        q = C.niels_negate(table[lanes, (mag - 1).clamp(min=0)], neg)
        q = torch.where((c != 0)[:, None, None], q, ident)
        acc = torch.where(need[warp][:, None, None], C.point_add_niels(acc, q), acc)
        started |= need
    acc = C.point_add_niels(acc, C.to_niels(F.words_to_limbs(points[:v][idx])))
    return F.limbs_to_words(acc)[:v]


MODELS = {"thread": thread_fold_model, "group": group_fold_model}


def _fold_words(kind: str, seed: int) -> torch.Tensor:
    """(1, 2, 8) fold_c words: random constants, the edge pairs (0, 1) /
    (L - 1, 1), or all -8 digits below the breakpoint."""
    rng = np.random.RandomState(seed)

    def rand():
        return Scalar(int.from_bytes(rng.bytes(32), "little") % L)

    pairs = {"random": (rand(), rand()), "zero-one": (Scalar(0), Scalar(1)),
             "L-1": (Scalar(L - 1), Scalar(1)), "all-8": (rand(), rand())}[kind]
    words = ck.c_fold_words([pairs], "cpu")
    if kind == "all-8":
        words[0, 0] = ALL_M8
    return words


@pytest.mark.parametrize("design", sorted(MODELS))
@pytest.mark.parametrize("kind", ["random", "zero-one", "L-1", "all-8"])
@pytest.mark.parametrize("v,bp", [(1, 0), (1, 1), (9, 0), (9, 2), (9, 6), (9, 9)])
def test_fold_c_model_matches_plain(design, kind, v, bp):
    """Both designs at v = 1 and 9 (a ragged last warp), breakpoints at 0,
    inside the first warp, inside the second and at v."""
    pts = F.from_raw(BulletproofGens(2 * v).G_raw(2 * v))
    words = _fold_words(kind, 600 + v + bp)
    got = MODELS[design](pts, words[0], bp)
    assert same_points(got, cc.fold_c_plain(pts, words, bp))


@pytest.mark.parametrize("design", sorted(MODELS))
def test_fold_c_comb_model_matches_plain(design):
    """fold_c_comb is the design's two sides, each with its own words."""
    v = 5
    pts = F.from_raw(BulletproofGens(4 * v).G_raw(4 * v))
    words = torch.cat([_fold_words("random", 620), _fold_words("zero-one", 621)])
    got = torch.cat([MODELS[design](pts[s * 2 * v : (s + 1) * 2 * v], words[s], 3)
                     for s in range(2)])
    assert same_points(got, cc.fold_c_comb_plain(pts, words, 3))


def test_fold_c_design_names():
    """The wrappers' design names map to the library's numbers; None lets
    the library choose; anything else is refused."""
    assert [cc._fold_c_design(d) for d in (None, "thread", "group")] == [-1, 0, 1]
    with pytest.raises(ValueError):
        cc._fold_c_design("ladder")


# -------------------------------------------------------- the host library
def test_native_library_is_named_by_host_cpu(monkeypatch):
    """The port's C++ host library (built with -march=native) carries the
    host CPU in its name: two CPUs give two paths, the same CPU the same
    path, in the same build directory."""
    monkeypatch.setattr(loader, "_cpu_id", lambda: "vendor A, flags avx2")
    a = loader.library_path()
    monkeypatch.setattr(loader, "_cpu_id", lambda: "vendor B, flags avx512f")
    b = loader.library_path()
    monkeypatch.setattr(loader, "_cpu_id", lambda: "vendor A, flags avx2")
    assert a != b
    assert loader.library_path() == a
    assert {p.rsplit("/", 1)[0] for p in (a, b)} == {loader.BUILD_DIR}


def test_native_cpu_id_is_stable():
    """This host's CPU identity is not empty and reads the same twice."""
    got = loader._cpu_id()
    assert got and got == loader._cpu_id()
