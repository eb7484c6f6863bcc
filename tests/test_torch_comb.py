"""The combined-layout IPP kernels of the port against the JAX package.

* The half-width fold encoders (``half_gcd_split``, ``w3h_digit_words``)
  equal the JAX package's bit for bit.
* ``fold_w3h``'s plain version equals the TPU kernel's ladder
  (``pallas_curve._emit_fold_w3h``, jitted once at 64 lanes) and the host
  beta * L + alpha * R; ``fold_w3h_comb``'s equals two ``fold_w3h`` calls.
* ``table_w4``'s plain version holds (k+1) * P, word for word the first
  half of ``table_w5``'s.
* ``msm_win_pair``'s plain version equals the TPU walker (``table_big`` +
  ``msm_win`` under ``pallas_call(interpret=True)``, two 2048-point
  chunks: one straight walk and one split walk, run once) and the host
  MSM at a combined round's geometry; ``msm_win``'s (one walk per call,
  the route flags' walker) equals the same two TPU walks.

CPU tensors route to the plain versions.  Tolerance: exact (equal points,
equal words and bits).
"""

import functools

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu.core import pedersen as jpedersen
from bulletproofs_r1cs_gadgets_tpu.core import scvec as jscvec
from bulletproofs_r1cs_gadgets_tpu.ops import chunks as jck
from bulletproofs_r1cs_gadgets_tpu.ops import pallas_curve as pc
from bulletproofs_r1cs_gadgets_tpu.utils.constants import L
from bulletproofs_r1cs_gadgets_tpu_torch import (
    BulletproofGens,
    Scalar,
    multiscalar_mul,
    scvec,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F

# The plain versions run many small tensor ops: intra-op threads gain
# nothing there and contend with the other test workers' processes.
torch.set_num_threads(1)

V = 64  # fold outputs: the emitter test's lane count (SUB x LAN)


def _consts(count: int, seed: int) -> list[int]:
    rng = np.random.RandomState(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(count)]
    return vals + [0, 1, 2, L - 1, L - 2, (L - 1) // 2, 1 << 126, L - (1 << 126)]


def test_half_gcd_split_matches_jax():
    for c in _consts(200, 1):
        got = ck.half_gcd_split(c, L)
        assert got == jck.half_gcd_split(c, L)
        alpha, beta = got
        assert abs(alpha) < 1 << 127 and abs(beta) < 1 << 127
        assert (alpha - beta * c) % L == 0


def test_w3h_digit_words_match_jax():
    edge = [0, 1, -1, 4, -4, 3, -5, (1 << 126) - 1, -(1 << 126),
            (1 << 126) + 12345, -(1 << 126) - 7, (1 << 129), -(1 << 129)]
    vals = edge + [x for c in _consts(50, 2) for x in ck.half_gcd_split(c, L)]
    for x in vals:
        w = ck.w3h_digit_words(x)
        assert w.dtype == np.int32 and w.shape == (8,)
        assert np.array_equal(w, jck.w3h_digit_words(x)), x
        codes = (w.view(np.uint32)[:, None] >> (4 * np.arange(8, dtype=np.uint32))) & 15
        digits = [int(c) - 8 if c >= 4 else int(c) for c in codes.reshape(-1)[:44]]
        assert sum(d << (3 * i) for i, d in enumerate(digits)) == x


def _gens(n: int):
    gens = BulletproofGens(n)
    return F.from_raw(gens.G_raw(n)), F.from_raw(gens.H_raw(n))


def _pairs_cases():
    a, b = _consts(2, 3)[:2]
    return {
        "random": ([ck.half_gcd_split(a, L), ck.half_gcd_split(b, L)], 23),
        "edge": ([(0, 1), (1, -1)], 40),
    }


@pytest.fixture(scope="module")
def jax_fold():
    """The TPU kernel's ladder (``_emit_fold_w3h``) over V lanes, jitted
    once and run for each case: lane i folds points i and i + V with the
    (beta, alpha) pair of its side of the breakpoint."""
    import jax
    import jax.numpy as jnp

    from test_kernel_emitters import LAN, _from_stacked, _to_stacked

    assert pc.SUB * LAN == V
    jg = jpedersen.BulletproofGens(2 * V)
    pts = jg.G(2 * V)
    left, right = _to_stacked(pts[:V]), _to_stacked(pts[V:])
    fn = jax.jit(pc._emit_fold_w3h)

    def lanes(rows):
        return jnp.asarray(np.ascontiguousarray(rows.T).reshape(8, pc.SUB, LAN))

    out = {}
    for name, (pairs, bp) in _pairs_cases().items():
        (aA, bA), (aB, bB) = pairs
        wl = lanes(jck._pw_w3h_rows(bA, bB, bp, V))
        wr = lanes(jck._pw_w3h_rows(aA, aB, bp, V))
        out[name] = [p.compress() for p in _from_stacked(fn(left, right, wl, wr))]
    return out


@pytest.mark.parametrize("case", ["random", "edge"])
def test_fold_w3h_plain_matches_tpu_ladder_and_host(case, jax_fold):
    G, _ = _gens(2 * V)
    pairs, bp = _pairs_cases()[case]
    words = ck.w3h_fold_words([pairs], "cpu")
    assert words.shape == (1, 2, 2, 8)
    got = F.to_points(cc.fold_w3h(G, words, bp))
    assert [p.compress() for p in got] == jax_fold[case]
    pts = F.to_points(G)
    for i in (0, 1, bp - 1, bp, V - 1):
        alpha, beta = pairs[0] if i < bp else pairs[1]
        want = (pts[i].scalar_mul(Scalar(beta % L))
                + pts[i + V].scalar_mul(Scalar(alpha % L)))
        assert got[i] == want, i


def test_fold_w3h_comb_plain_is_two_side_folds():
    G, H = _gens(16)
    m = 4
    C = torch.cat([G[: 2 * m], H[: 2 * m]])
    sides = [_pairs_cases()["random"][0], [(7, -3), (0, 1)]]
    words = ck.w3h_fold_words(sides, "cpu")
    for bp in (0, 3, m):
        got = cc.fold_w3h_comb(C, words, bp)
        assert got.shape == (2 * m, 4, 8)
        assert torch.equal(got[:m], cc.fold_w3h(G[: 2 * m], words[:1], bp))
        assert torch.equal(got[m:], cc.fold_w3h(H[: 2 * m], words[1:], bp))
    # `out` takes the result; one side's fold never aliases its input
    out = torch.empty((m, 4, 8), dtype=torch.int32)
    assert cc.fold_w3h(G[: 2 * m], words[:1], 2, out=out) is out
    with pytest.raises(ValueError):
        cc.fold_w3h(G[: 2 * m], words, 2)  # two sides' words for one side


def test_table_w4_plain_entries():
    G, _ = _gens(4)
    tbl = cc.table_w4(G)
    assert tbl.shape == (4, cc.TBL4, 4, 8)
    assert torch.equal(tbl, cc.table_w5(G)[:, : cc.TBL4])
    from bulletproofs_r1cs_gadgets_tpu_torch.utils.constants import D2, P

    inv2 = pow(2, P - 2, P)
    for i, p in enumerate(F.to_points(G)):
        ints = F.words_to_ints(tbl[i].numpy())
        for k in range(cc.TBL4):
            ypx, ymx, t2d, z = ints[4 * k : 4 * k + 4]
            X, Y = (ypx - ymx) * inv2 % P, (ypx + ymx) * inv2 % P
            assert t2d * z % P == D2 * X * Y % P
            q = p.scalar_mul(Scalar(k + 1))
            zi, qzi = pow(z, P - 2, P), pow(q.Z, P - 2, P)
            assert (X * zi % P, Y * zi % P) == (q.X * qzi % P, q.Y * qzi % P)
    spare = torch.zeros((6, cc.TBL4, 4, 8), dtype=torch.int32)
    got = cc.table_w4(G, out=spare)
    assert torch.equal(got, tbl) and torch.equal(spare[:4], tbl)
    with pytest.raises(ValueError):
        cc.table_w4(G, out=spare[:3])


# msm_win_pair's walks in points for the two TPU walks over two chunks:
# straight (table chunk 1, word chunk 0) and split (word chunks 0, 1 over
# table chunks 1, then 0)
_C = jck.CHUNK
PAIR_WALKS = ((_C, _C, 0, _C, _C), (2 * _C, _C, 0, _C, 0))


def _pair_rows():
    rows = jscvec.from_wide_bytes(np.random.RandomState(9).bytes(64 * 2 * _C))
    rows[:3] = jscvec.from_ints([0, 1, L - 1])
    rows[_C : _C + 2] = jscvec.from_ints([L - 1, 0])
    return rows


@pytest.fixture(scope="module")
def jax_pair(request):
    """ONE interpret-mode table_big and two msm_win walks of the TPU
    walker over the first 4096 generators."""
    from jax.experimental import pallas as pl

    from bulletproofs_r1cs_gadgets_tpu.ops.pallas_backend import PallasBackend

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    fns = (pc.table_grid_full, pc.msm_win_dyn)
    for fn in fns:
        fn.clear_cache()

    def fin():
        pl.pallas_call = orig
        for fn in fns:
            fn.clear_cache()

    request.addfinalizer(fin)
    n = 2 * _C
    share = jpedersen.BulletproofGens(n).share(0)
    tbl = jck.table_big(PallasBackend()._gens_big(share, n, "G"), 2)
    w = jck.grid_words(_pair_rows(), 2)
    straight = jck.msm_win(tbl, w, 1, poff=1, woff=0)
    split = jck.msm_win(tbl, w, 2, poff=1, split=1, poff2=0)
    return [p.compress() for p in jck.fetch_points([straight, split])]


@pytest.mark.kernelmath
def test_msm_win_pair_plain_matches_tpu_walker(jax_pair):
    G, _ = _gens(2 * _C)
    got = cc.msm_win_pair(
        cc.table_w4(G), ck.w4_words(_pair_rows(), "cpu"),
        F.identity_points(2), PAIR_WALKS,
    )
    assert [p.compress() for p in F.to_points(got)] == jax_pair


@pytest.mark.kernelmath
def test_msm_win_plain_matches_tpu_walker(jax_pair):
    """``msm_win``, the counterpart of ``msm_win_dyn`` itself: the same
    straight and wrap walks, one walk per call."""
    G, _ = _gens(2 * _C)
    tbl, words = cc.table_w4(G), ck.w4_words(_pair_rows(), "cpu")
    ident = F.identity_points(1)
    got = torch.cat([cc.msm_win(tbl, words, ident, *w) for w in PAIR_WALKS])
    assert [p.compress() for p in F.to_points(got)] == jax_pair


def test_msm_win_pair_plain_matches_host_at_a_combined_round():
    n = 8
    G, H = _gens(2 * n)
    pts = torch.cat([G, H])  # [G(2n) | H(2n)]
    rows = scvec.from_wide_bytes(np.random.RandomState(4).bytes(64 * 4 * n))
    rows[:2] = scvec.from_ints([0, L - 1])
    words = ck.w4_words(rows, "cpu")
    words[3] = np.int32(-0x77777778)  # 0x88888888: every digit -8
    sc = [Scalar(v) for v in scvec.to_ints(rows)]
    sc[3] = Scalar(sum(-8 << (4 * i) for i in range(64)) % L)
    B = F.to_points(pts[:1])[0].double()
    chain2 = F.from_points([B, B.double()])
    got = F.to_points(cc.msm_win_pair(cc.table_w4(pts), words, chain2,
                                      ck.comb_walks(n)))
    P = F.to_points(pts)
    assert got[0] == multiscalar_mul(sc[: 2 * n], P[n : 3 * n]) + B
    assert got[1] == (multiscalar_mul(sc[2 * n : 3 * n], P[:n])
                      + multiscalar_mul(sc[3 * n :], P[3 * n :]) + B.double())
    with pytest.raises(ValueError):  # a walk past the table's end
        cc.msm_win_pair(cc.table_w4(pts), words, chain2, ck.comb_walks(2 * n))
