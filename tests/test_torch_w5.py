"""The port's w5 shared-table walker (``table_w5``, ``msm_win5``) against
the JAX package's.

Same inputs, made from a numpy seed, go through the JAX encoder
``signed_digit5_bytes`` and the TPU kernels ``table_grid5_full`` +
``msm_win5_dyn`` (run once, under ``pallas_call(interpret=True)`` at their
minimal geometry of one 2048-point chunk, as tests/test_w5.py runs them)
and through the port's encoder and plain versions (CPU tensors route to
them).  Cases cover scalars 0, 1, L-1 and a scalar of fifty -16 digits
(the 16P entry negated), zero words, and the walk's offset / split
geometry.  Tolerance: exact (equal words, equal points).
"""

import functools

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu import BulletproofGens, PedersenGens, Scalar
from bulletproofs_r1cs_gadgets_tpu.core import scvec
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import (
    RistrettoPoint,
    multiscalar_mul,
)
from bulletproofs_r1cs_gadgets_tpu.ops import chunks as jck
from bulletproofs_r1cs_gadgets_tpu.ops import pallas_curve as pc
from bulletproofs_r1cs_gadgets_tpu.utils.constants import D2, L, P
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F

# The plain versions run many small tensor ops: intra-op threads gain
# nothing there and contend with the other test workers' processes.
torch.set_num_threads(1)


def to_points(t: torch.Tensor) -> list[RistrettoPoint]:
    """The port's points of a (n, 4, 8) tensor as the JAX package's
    RistrettoPoints (the reference type the results are held against)."""
    return [RistrettoPoint(p.X, p.Y, p.Z, p.T) for p in F.to_points(t)]

# digits -16 in windows 0..49 and 1 in window 50
ALL_MINUS_16 = (1 << 250) - 16 * ((1 << 250) - 1) // 31


def _edge_rows(n: int, seed: int) -> np.ndarray:
    rows = scvec.from_wide_bytes(np.random.RandomState(seed).bytes(64 * n))
    rows[:4] = scvec.from_ints([0, 1, L - 1, ALL_MINUS_16])
    return rows


def _digits(row16: np.ndarray) -> list[int]:
    by = np.ascontiguousarray(row16, dtype="<i4").view(np.uint8)
    codes = [int(b) & 31 for b in by[: cc.W5_WINDOWS]]
    return [c - 32 if c >= 16 else c for c in codes]


def _points(n: int, seed: int):
    rng = np.random.RandomState(seed)
    B = PedersenGens.default().B
    return [
        B.scalar_mul(Scalar(int.from_bytes(rng.bytes(31), "little") + 1))
        for _ in range(n)
    ]


def test_signed_digit5_bytes_match_jax():
    rows = _edge_rows(300, 1)
    got = ck.signed_digit5_bytes(rows)
    assert got.dtype == np.int32 and got.shape == (300, 16)
    assert np.array_equal(got, jck.signed_digit5_bytes(rows))
    for row, v in zip(got[:8], scvec.to_scalars(rows[:8])):
        d = _digits(row)
        assert sum(x * 32**i for i, x in enumerate(d)) == v.v
    assert _digits(got[3]) == [-16] * 50 + [1]
    assert not got[0].any()  # a zero scalar is zero words
    assert not ck.signed_digit5_bytes(np.zeros((3, 4), np.uint64)).any()
    assert torch.equal(ck.w5_words(rows, "cpu"), torch.from_numpy(got))


def _niels_affine(entry: np.ndarray) -> tuple[int, int]:
    """One (4, 8) niels entry -> affine (x, y); checks 2dT against X, Y."""
    ypx, ymx, t2d, z = F.words_to_ints(entry)
    inv2 = pow(2, P - 2, P)
    X, Y = (ypx - ymx) * inv2 % P, (ypx + ymx) * inv2 % P
    assert t2d * z % P == D2 * X * Y % P
    zi = pow(z, P - 2, P)
    return X * zi % P, Y * zi % P


def test_table_w5_plain_entries_are_multiples():
    pts = _points(5, 2)
    tbl = cc.table_w5(F.from_points(pts)).numpy()
    assert tbl.shape == (5, cc.TBL5, 4, 8)
    for i, p in enumerate(pts):
        for k in range(cc.TBL5):
            q = p.scalar_mul(Scalar(k + 1))
            zi = pow(q.Z, P - 2, P)
            assert _niels_affine(tbl[i, k]) == (q.X * zi % P, q.Y * zi % P)
    # canonical words: every coordinate below p
    assert all(v < P for v in F.words_to_ints(tbl.reshape(-1, 8)))


@pytest.mark.parametrize(
    "v, poff, woff, split, poff2",
    [(9, 0, 0, None, 0), (7, 3, 2, None, 0), (10, 4, 0, 4, 0),
     (10, 0, 1, 0, 5), (6, 2, 3, 6, 0), (0, 0, 0, None, 0)],
)
def test_msm_win5_walk_geometry_matches_host(v, poff, woff, split, poff2):
    """Steps j < split read table row poff + j, later steps row
    poff2 + (j - split); step j's digits come from word row woff + j."""
    pts = _points(16, 3)
    rows = _edge_rows(16, 4)
    tbl = cc.table_w5(F.from_points(pts))
    chain_pt = pts[0].double()
    got = cc.msm_win5(
        tbl, ck.w5_words(rows, "cpu"), F.from_points([chain_pt]), v,
        poff=poff, woff=woff, split=split, poff2=poff2,
    )
    sp = v if split is None else split
    base = poff if split is None else poff2
    idx = [poff + j if j < sp else base + j - sp for j in range(v)]
    sc = scvec.to_scalars(rows)
    want = multiscalar_mul(
        [sc[woff + j] for j in range(v)] + [Scalar.one()],
        [pts[i] for i in idx] + [chain_pt],
    )
    assert to_points(got)[0] == want


def test_msm_win5_refuses_walks_off_the_table():
    tbl = cc.table_w5(F.identity_points(4))
    words = torch.zeros((4, 16), dtype=torch.int32)
    acc = F.identity_points(1)
    with pytest.raises(ValueError):
        cc.msm_win5(tbl, words, acc, 3, poff=2)
    with pytest.raises(ValueError):
        cc.msm_win5(tbl, words, acc, 4, woff=1)
    with pytest.raises(ValueError):
        cc.msm_win5(tbl, words, acc, 3, split=1, poff2=3)
    with pytest.raises(ValueError):
        cc.msm_win5(tbl, words[:, :8].contiguous(), acc, 2)


@pytest.fixture(scope="module")
def jax_win5(request):
    """ONE interpret-mode run of the TPU table prepass + w5 walker over
    2048 generators and scalars (the minimal geometry), shared by the
    comparisons below."""
    from jax.experimental import pallas as pl

    from bulletproofs_r1cs_gadgets_tpu.ops.pallas_backend import PallasBackend

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    for fn in (pc.table_grid5_full, pc.msm_win5_dyn):
        fn.clear_cache()

    def fin():
        pl.pallas_call = orig
        for fn in (pc.table_grid5_full, pc.msm_win5_dyn):
            fn.clear_cache()

    request.addfinalizer(fin)
    n = jck.CHUNK
    gens = BulletproofGens(n)
    share = gens.share(0)
    big = PallasBackend()._gens_big(share, 2 * n, "G")  # 2-chunk capacity
    rows = _edge_rows(n, 5)
    acc = jck.msm_win5(jck.table_big5(big, 1), jck.grid_words5(rows, 1), 1)
    return {
        "share": share, "rows": rows, "n": n,
        "total": jck.fetch_points([acc])[0],
    }


@pytest.mark.kernelmath
def test_msm_win5_plain_matches_tpu_kernel(jax_win5):
    d = jax_win5
    n = d["n"]
    G = F.from_raw(d["share"].G_raw(n))
    got = cc.msm_win5(
        cc.table_w5(G), ck.w5_words(d["rows"], "cpu"), F.identity_points(1), n
    )
    total = to_points(got)[0]
    assert total == d["total"]
    assert total == multiscalar_mul(
        scvec.to_scalars(d["rows"]), d["share"].G(n)
    )
