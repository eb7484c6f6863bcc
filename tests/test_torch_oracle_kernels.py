"""The device-oracle path's kernels, through their plain versions on the CPU.

The seven TPU kernels of this path (``padd``, ``pdbl``, ``smul_lanes``,
``msm_block_totals``, ``msm_chunk_acc``, ``fold_grid``, ``mul_fq`` /
``mul_fp``) run on a TPU only, but their bodies are jnp emitters that run
anywhere (as ``tests/test_kernel_emitters.py`` runs them): each is jitted
once here at 64 points (a lane count of 8) and fed the same seeded inputs
as the port's plain version, its output converted by ``carry``.  The
port's kernels run the TPU's own operation sequence, so the two agree
word for word mod p (the T-elided TPU steps compute the same X, Y, Z).
The block sums, whose tree differs from the TPU's rotate-and-add, are held
against the host ``multiscalar_mul`` per 2048-point block and in total.
Tolerance: equal values mod the modulus, equal group elements.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu.core import scvec as jscvec
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import (
    RistrettoPoint as JPoint,
    multiscalar_mul as jmsm,
)
from bulletproofs_r1cs_gadgets_tpu.core.scalar import Scalar as JScalar
from bulletproofs_r1cs_gadgets_tpu.ops import chunks as jck
from bulletproofs_r1cs_gadgets_tpu.ops import pallas_curve as pc
from bulletproofs_r1cs_gadgets_tpu.ops import pallas_field as pf
from bulletproofs_r1cs_gadgets_tpu.ops.curve import _ints_to_limbs_vec
from bulletproofs_r1cs_gadgets_tpu.ops.field import STORE, ints_to_limbs
from bulletproofs_r1cs_gadgets_tpu_torch import carry
from bulletproofs_r1cs_gadgets_tpu_torch.core import scvec
from bulletproofs_r1cs_gadgets_tpu_torch.core.ristretto import (
    RistrettoPoint as TPoint,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F
from bulletproofs_r1cs_gadgets_tpu_torch.utils.constants import L, P

torch.set_num_threads(1)

LAN = 8
N = pc.SUB * LAN  # 64 points, the emitters' lattice (8, LAN)
rng = np.random.RandomState(20261017)


def _rand_ints(n: int, bits: int = 256) -> list[int]:
    return [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(n)]


def _points(n: int) -> list[JPoint]:
    """Seeded points with Z != 1 (a random multiple of the basepoint plus
    itself), as host objects of the JAX package."""
    B = JPoint.basepoint()
    out = []
    for k in _rand_ints(n, 248):
        p = B.scalar_mul(JScalar(k % L + 1))
        out.append(p + p)
    return out


def _jax_stacked(points):
    """Host points -> the emitters' tuple of 4 (STORE, 8, LAN) stacks."""
    coords = [c for p in points for c in (p.X, p.Y, p.Z, p.T)]
    limbs = _ints_to_limbs_vec(coords).reshape(len(points), pc.ROWS)
    arr = jnp.asarray(np.ascontiguousarray(limbs.T).reshape(pc.ROWS, pc.SUB, LAN))
    return tuple(arr[c * STORE : (c + 1) * STORE] for c in range(4))


def _port_points(points) -> torch.Tensor:
    coords = [c for p in points for c in (p.X, p.Y, p.Z, p.T)]
    return torch.from_numpy(F.ints_to_words(coords).reshape(-1, 4, 8).copy())


def _jax_words(rows: np.ndarray) -> jnp.ndarray:
    """(N, 8) word rows -> the emitters' (8, 8, LAN) word stack."""
    return jnp.asarray(np.ascontiguousarray(rows.T).reshape(8, pc.SUB, LAN))


def _same_group_elements(got: torch.Tensor, want) -> bool:
    return F.to_points(got) == [TPoint(w.X, w.Y, w.Z, w.T) for w in want]


# ------------------------------------------------------------ JAX templates
@pytest.fixture(scope="module")
def jax_add():
    return jax.jit(pc.emit_point_add)


@pytest.fixture(scope="module")
def jax_dbl():
    return jax.jit(pc.emit_point_double)


@pytest.fixture(scope="module")
def jax_ladder():
    return jax.jit(lambda p, w: pc._ladder(p, w, False))


@pytest.fixture(scope="module")
def jax_fold_w2():
    return jax.jit(pc._emit_fold_w2)


def test_padd_pdbl_plain_match_jax_emitters(jax_add, jax_dbl):
    ps, qs = _points(N), _points(N)
    qs[0] = ps[0]                      # P + P
    qs[1] = -ps[1]                     # P + (-P) = identity
    qs[2] = JPoint.identity()
    ps[3] = JPoint.identity()
    tp, tq = _port_points(ps), _port_points(qs)
    got_add = cc.padd_plain(tp, tq)
    got_dbl = cc.pdbl_plain(tp)
    want_add = carry.stacked_points(jax_add(_jax_stacked(ps), _jax_stacked(qs)))
    want_dbl = carry.stacked_points(jax_dbl(_jax_stacked(ps)))
    assert torch.equal(got_add, want_add)
    assert torch.equal(got_dbl, want_dbl)
    assert _same_group_elements(got_add, [p + q for p, q in zip(ps, qs)])
    assert _same_group_elements(got_dbl, [p.double() for p in ps])
    assert F.to_points(got_add)[1].is_identity()
    # the wrappers take the plain route on CPU tensors
    assert torch.equal(cc.padd(tp, tq), got_add)
    assert torch.equal(cc.pdbl(tp), got_dbl)


def test_smul_lanes_plain_matches_jax_ladder(jax_ladder):
    ps = _points(N)
    ks = [k % L for k in _rand_ints(N)]
    ks[:4] = [0, 1, L - 1, (1 << 253) - 1]  # top bit set, past l
    rows = scvec.from_ints([k % L for k in ks])
    rows[3] = np.frombuffer(((1 << 253) - 1).to_bytes(32, "little"), "<u8")
    words = ck.bit_words(rows)
    got = cc.smul_lanes(_port_points(ps), torch.from_numpy(words))
    want = carry.stacked_points(jax_ladder(_jax_stacked(ps), _jax_words(words)))
    assert torch.equal(got, want)
    assert _same_group_elements(
        got[:8], [p.scalar_mul(JScalar(k)) for p, k in zip(ps[:8], ks[:8])]
    )
    assert F.to_points(got)[0].is_identity()


def test_fold_grid_plain_matches_jax_fold_w2(jax_fold_w2):
    ls, rs = _points(N), _points(N)
    a = [k % L for k in _rand_ints(N)]
    b = [k % L for k in _rand_ints(N)]
    a[:3], b[:3] = [0, 1, L - 1], [0, L - 1, 1]
    ra, rb = scvec.from_ints(a), scvec.from_ints(b)
    wa, wb = ck.signed_digit2_words(ra), ck.signed_digit2_words(rb)
    # the port's encoder is the reference's, bit for bit
    assert np.array_equal(wa, jck.signed_digit2_words(jscvec.from_ints(a)))
    pts = torch.cat([_port_points(ls), _port_points(rs)])
    jl, jr = _jax_stacked(ls), _jax_stacked(rs)
    got = cc.fold_grid(pts, torch.from_numpy(wa), torch.from_numpy(wb), N)
    want = carry.stacked_points(jax_fold_w2(jl, jr, _jax_words(wa), _jax_words(wb)))
    assert torch.equal(got, want)
    assert _same_group_elements(got[:8], [
        l.scalar_mul(JScalar(x)) + r.scalar_mul(JScalar(y))
        for l, r, x, y in zip(ls[:8], rs[:8], a[:8], b[:8])
    ])
    # constants: one (1, 8) row for every lane, as every lane a copy
    u, u_inv = a[5], pow(a[5], L - 2, L)
    cu = ck.const_grid_words(scvec.row_to_scalar(scvec.from_ints([u])[0]), "cpu")
    ci = ck.const_grid_words(scvec.row_to_scalar(scvec.from_ints([u_inv])[0]),
                             "cpu")
    got = cc.fold_grid(pts, ci, cu, N)
    want = carry.stacked_points(jax_fold_w2(
        jl, jr, _jax_words(np.repeat(ci.numpy(), N, 0)),
        _jax_words(np.repeat(cu.numpy(), N, 0)),
    ))
    assert torch.equal(got, want)
    # only rows i and i + v are read: a longer tensor folds the same
    extra = torch.cat([pts, _port_points(_points(3))])
    assert torch.equal(cc.fold_grid(extra, ci, cu, N), got)


@pytest.mark.parametrize("field, modulus", [("fq", L), ("fp", P)],
                         ids=["fq", "fp"])
def test_mul_plain_matches_jax_emit_mul(field, modulus):
    xs = _rand_ints(N)
    ys = _rand_ints(N)
    edge = [0, 1, modulus - 1, (1 << 256) - 1]
    xs[:8] = edge + [modulus - 1, (1 << 256) - 1, 1, modulus]
    ys[:8] = edge[::-1] + [modulus - 1, (1 << 256) - 1, modulus + 1, 2]
    plain = cc.mul_fq_plain if field == "fq" else cc.mul_fp_plain
    wrap = cc.mul_fq if field == "fq" else cc.mul_fp
    a = torch.from_numpy(F.ints_to_words(xs).copy())
    b = torch.from_numpy(F.ints_to_words(ys).copy())
    got = plain(a, b)
    assert F.words_to_ints(got.numpy()) == [x * y % modulus for x, y in zip(xs, ys)]
    assert torch.equal(wrap(a, b), got)

    def stack(vals):
        limbs = ints_to_limbs(vals)  # (N, STORE) unsigned 12-bit limbs
        return jnp.asarray(np.ascontiguousarray(limbs.T).reshape(STORE, pc.SUB, LAN))

    out = jax.jit(lambda u, v: pf.emit_mul(u, v, field))(stack(xs), stack(ys))
    assert torch.equal(carry.stacked_field(out, modulus), got)


def test_block_totals_and_chunk_acc_plain_match_host(monkeypatch):
    """msm_block_totals over n = 2048 + 37 (a ragged second block) with
    all-zero word rows: each total equals the host MSM of its 2048-point
    block.  msm_chunk_acc over 300 of those points equals their MSM plus
    acc (the identity, and a point); with the points per partial lowered
    to 4, its second pass walks 75 partials on 4 threads."""
    n = cc.BLOCK_PTS + 37
    B = JPoint.basepoint()
    base = _points(64)
    mults = [B.scalar_mul(JScalar(j + 1)) for j in range(n // 64 + 1)]
    pts = [base[i % 64] + mults[i // 64] for i in range(n)]
    ks = [k % L for k in _rand_ints(n)]
    for i in (0, 5, 2047, 2048, n - 1):
        ks[i] = 0
    ks[7] = L - 1
    tp = _port_points(pts)
    words = torch.from_numpy(ck.bit_words(scvec.from_ints(ks)))
    scal = [JScalar(k) for k in ks]
    totals = cc.msm_block_totals(tp, words)
    assert totals.shape == (2, 4, 8)
    assert _same_group_elements(
        totals, [jmsm(scal[:2048], pts[:2048]), jmsm(scal[2048:], pts[2048:])]
    )
    assert cc.msm_block_totals(tp[:0], words[:0]).shape == (0, 4, 8)

    m = 300
    total = jmsm(scal[:m], pts[:m])
    acc_pt = base[3]
    acc = _port_points([acc_pt])
    ident = _port_points([JPoint.identity()])
    assert _same_group_elements(cc.msm_chunk_acc(tp[:m], words[:m], ident),
                                [total])
    monkeypatch.setattr(cc, "ORACLE_THREADS", 4)
    assert _same_group_elements(cc.msm_chunk_acc(tp[:m], words[:m], acc),
                                [total + acc_pt])
    assert _same_group_elements(cc.msm_chunk_acc(tp[:0], words[:0], acc),
                                [acc_pt])
