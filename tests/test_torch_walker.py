"""The window walkers' host side and edge walks, on the CPU.

* ``build.ptxas_usage`` reads registers, stack and spills per kernel from
  ptxas's report (the build keeps it beside the library; ``chip_smoke.py``
  logs the walkers' lines).
* ``cuda_curve.fe_mul_test``, the test entry of the carry-chain multiply
  and squaring, takes its plain version on CPU tensors: products mod p,
  canonical, equal to Python ints on the edge operands (values >= p
  included), and it refuses an unknown operation.
* ``msm_win5`` / ``msm_win`` / ``msm_win_pair`` (plain versions on CPU
  tensors) at the edge walks the card tests use: one step, an all-zero
  word range, rows of all -16 / -8 digits, a split walk over both ends of
  the table, pair walks of unequal length, a non-identity chain; each
  equal to the host ``multiscalar_mul``.

Tolerance: exact (equal ints, equal points).
"""

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu_torch import (
    BulletproofGens,
    L,
    PedersenGens,
    Scalar,
    multiscalar_mul,
    scvec,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import build
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F

torch.set_num_threads(1)

P = (1 << 255) - 19
EDGES = [0, 1, P - 1, P, P + 1, 1 << 255, (1 << 256) - 38, (1 << 256) - 1]
N = 64

PTXAS = """\
ptxas info    : 0 bytes gmem, 64 bytes cmem[3]
ptxas info    : Function properties for _Z6ge_addRK2geS1_
    128 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z16msm_win_partialsILi5EEvPKiS1_Pi6walks2i' for 'sm_90a'
ptxas info    : Function properties for _Z16msm_win_partialsILi5EEvPKiS1_Pi6walks2i
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 512 bytes smem, 408 bytes cmem[0]
ptxas info    : Compiling entry function '_Z14msm_win_hornerILi4EEvPKiS1_Pi' for 'sm_90a'
ptxas info    : Function properties for _Z14msm_win_hornerILi4EEvPKiS1_Pi
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 8192 bytes smem, 376 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_entry_function():
    got = build.ptxas_usage(PTXAS)
    assert got == {
        "_Z16msm_win_partialsILi5EEvPKiS1_Pi6walks2i": dict(
            registers=168, stack=0, spill_stores=0, spill_loads=0),
        "_Z14msm_win_hornerILi4EEvPKiS1_Pi": dict(
            registers=255, stack=24, spill_stores=8, spill_loads=12),
    }  # the out-of-line device function is no entry
    assert build.ptxas_usage("") == {}


@pytest.mark.parametrize("op", cc.FE_MUL_TEST_OPS)
@pytest.mark.parametrize("reps", [1, 3])
def test_fe_mul_test_plain_matches_python_ints(op, reps):
    pairs = [(x, y) for x in EDGES for y in EDGES]
    a = torch.from_numpy(F.ints_to_words([x for x, _ in pairs]).copy())
    b = torch.from_numpy(F.ints_to_words([y for _, y in pairs]).copy())
    before = dict(cc.LAUNCHES)
    got = F.words_to_ints(cc.fe_mul_test(a, b, op, reps).numpy())
    assert cc.LAUNCHES == before  # CPU tensors: the plain version
    want = []
    for x, y in pairs:
        for _ in range(reps):
            x = x * (x if op.startswith("fe_sq") else y) % P
        want.append(x)
    assert got == want


def test_fe_mul_test_refuses_bad_arguments():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        cc.fe_mul_test(a, a, "fe_cube")
    with pytest.raises(ValueError):
        cc.fe_mul_test(a, a, "fe_mul", 0)
    with pytest.raises(ValueError):
        cc.fe_mul_test(a, a[:3].contiguous(), "fe_mul")


def _inputs(bits: int, seed: int):
    """N generators and their table, words with an all-zero range at rows
    8-15 and all -16 / -8 digit rows at 16-19, a non-identity chain."""
    pts = F.from_raw(BulletproofGens(N).G_raw(N))
    rows = scvec.from_wide_bytes(np.random.RandomState(seed).bytes(64 * N))
    rows[:3] = scvec.from_ints([0, 1, L - 1])
    rows[8:16] = 0
    if bits == 5:
        tbl, words = cc.table_w5(pts), ck.w5_words(rows, "cpu")
        words[16:20] = 0x10101010  # code 16 in every byte: digits -16
    else:
        tbl, words = cc.table_w4(pts), ck.w4_words(rows, "cpu")
        words[16:20] = -0x77777778  # 0x88888888: digits -8
    chain = PedersenGens.default().B.double()
    return pts, tbl, words, chain


def host_walk(pts, words, chain, walk, bits):
    """The host MSM of a walk (v, poff, woff, split, poff2) over the points
    `pts`, from the digits of `words` (w5 bytes or w4 nibbles, any device),
    plus the host point `chain` (also for ``tests/test_torch_cuda.py``)."""
    v, poff, woff, split, poff2 = walk
    idx = [poff + j if j < split else poff2 + j - split for j in range(v)]
    per, width = (4, 8) if bits == 5 else (8, 4)
    wins = cc.W5_WINDOWS if bits == 5 else cc.W4_WINDOWS
    half = 1 << (bits - 1)
    scalars = []
    for row in words[woff : woff + v].cpu().numpy():
        total = 0
        for win in range(wins):
            code = (int(row[win // per]) >> (width * (win % per))) & (2 * half - 1)
            total += (code - 2 * half if code >= half else code) << (bits * win)
        scalars.append(Scalar(total % L))
    host = F.to_points(pts[idx]) if v else []
    return multiscalar_mul(scalars + [Scalar(1)], host + [chain])


# (v, poff, woff, split, poff2): one step, the all-zero range, the -16 /
# -8 rows, a split walk over both ends of the table
EDGE_WALKS = [(1, 5, 2, 1, 0), (8, 0, 8, 8, 0), (4, 30, 16, 4, 0),
              (12, N - 5, 14, 5, 3)]


@pytest.mark.parametrize("bits", [5, 4])
def test_walker_edge_walks_match_host(bits):
    pts, tbl, words, chain = _inputs(bits, 160 + bits)
    walk_fn = cc.msm_win5 if bits == 5 else cc.msm_win
    c = F.from_points([chain])
    for walk in EDGE_WALKS:
        got = F.to_points(walk_fn(tbl, words, c, *walk))[0]
        assert got == host_walk(pts, words, chain, walk, bits), walk
    assert F.to_points(walk_fn(tbl, words, c, *EDGE_WALKS[1]))[0] == chain


def test_walker_pair_of_unequal_walks_matches_host():
    pts, tbl, words, chain = _inputs(4, 170)
    other = chain.double()
    pair = (EDGE_WALKS[3], (1, 5, 2, 1, 0))
    got = F.to_points(cc.msm_win_pair(tbl, words, F.from_points([chain, other]),
                                      pair))
    assert got[0] == host_walk(pts, words, chain, pair[0], 4)
    assert got[1] == host_walk(pts, words, other, pair[1], 4)
