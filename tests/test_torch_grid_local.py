"""The port's ``msm_grid_local`` (one shard's walk of the points-axis
sharded MSM) against the JAX package's TPU kernel, and the carried
capacity layouts it is fed through.

* Kernel: the JAX package's ``pallas_curve.msm_grid_local`` runs once per
  valid count under ``pallas_call(interpret=True)`` (as
  tests/test_torch_flags.py runs ``msm_grid_acc``) over a two-chunk shard
  (4,096 generators) with a chained accumulator; its words are nonzero in
  every eighth row of both chunks, so the clamp decides the result.  The
  port's plain version (the wrapper on CPU tensors) gets the same arrays
  through ``carry.capacity_points`` / ``capacity_words`` and must give the
  same point at valid 1 and 2; valid 0 returns the accumulator.  A small
  shard is held against the host ``multiscalar_mul``.
* Carry: a carried capacity array equals ``F.from_raw`` of the same
  generators in their order, and carried words equal the port's own w4
  encoding of the same scalars, zero past them.

CPU tensors route to the plain versions.  Tolerance: exact (equal
points, equal words).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu.core.pedersen import (
    BulletproofGens as JBulletproofGens,
)
from bulletproofs_r1cs_gadgets_tpu.core.pedersen import (
    PedersenGens as JPedersenGens,
)
from bulletproofs_r1cs_gadgets_tpu.ops import chunks as jck
from bulletproofs_r1cs_gadgets_tpu.ops import pallas_curve as pc
from bulletproofs_r1cs_gadgets_tpu.utils.constants import L
from bulletproofs_r1cs_gadgets_tpu_torch import (
    PedersenGens,
    multiscalar_mul,
    scvec,
)
from bulletproofs_r1cs_gadgets_tpu_torch.carry import (
    capacity_points,
    capacity_words,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F

torch.set_num_threads(1)

_C = jck.CHUNK
N = 2 * _C  # the shard: two chunks


def _rows() -> np.ndarray:
    """Scalars nonzero in every eighth row of both chunks (0, 1 and L - 1
    among them): the plain ladder skips zero rows, the TPU kernel walks
    them."""
    rows = np.zeros((N, 4), np.uint64)
    live = scvec.from_wide_bytes(np.random.RandomState(31).bytes(64 * N // 8))
    live[:3] = scvec.from_ints([0, 1, L - 1])
    rows[::8] = live
    return rows


@pytest.fixture(scope="module")
def shard(request):
    """The shard's capacity arrays and the JAX kernel's total at valid 1
    and 2 (one interpret-mode compile serves both)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    pc.msm_grid_local.clear_cache()

    def fin():
        pl.pallas_call = orig
        pc.msm_grid_local.clear_cache()

    request.addfinalizer(fin)
    share = JBulletproofGens(N).share(0)
    big = jnp.concatenate(jck.points_to_chunks(share.G(N)), axis=2)
    words = np.concatenate(jck.words_chunks(_rows(), 2, encode="w4"), axis=2)
    acc = jck.broadcast_chunk(JPedersenGens.default().B)
    totals = {}
    for valid in (1, 2):
        info = jnp.asarray(np.array([valid, 0], np.int32))
        out = pc.msm_grid_local(big, jnp.asarray(words), acc, info)
        (totals[valid],) = jck.fetch_points([out])
    return {"raw": share.G_raw(N), "big": np.asarray(big), "words": words,
            "totals": totals}


@pytest.mark.kernelmath
@pytest.mark.parametrize("valid", [1, 2])
def test_msm_grid_local_plain_matches_tpu_kernel(shard, valid):
    pts = capacity_points(shard["big"])
    words = capacity_words(shard["words"])
    acc = F.from_points([PedersenGens.default().B])
    got = F.to_points(cc.msm_grid_local(pts, words, acc, valid, _C))[0]
    want = shard["totals"][valid]
    assert got.compress() == want.compress()
    assert F.to_points(cc.msm_grid_local_plain(pts, words, acc, valid, _C)) \
        == [got]


def test_carried_capacity_arrays_are_the_generators_in_order(shard):
    """Points: F.from_raw of the same generators, row for row (the carry
    undoes the chunks' sublane/lane order).  Words: the port's w4 words of
    the same scalars; the pairs stay aligned."""
    assert torch.equal(capacity_points(shard["big"]), F.from_raw(shard["raw"]))
    assert torch.equal(capacity_words(shard["words"]),
                       torch.from_numpy(ck.signed_digit_words(_rows())))
    short = np.concatenate(jck.words_chunks(_rows()[:100], 2, encode="w4"),
                           axis=2)
    got = capacity_words(short)
    assert torch.equal(got[:100],
                       torch.from_numpy(ck.signed_digit_words(_rows()[:100])))
    assert not got[100:].any()
    with pytest.raises(ValueError):
        capacity_words(short[:, :, :100])


def test_msm_grid_local_clamps_and_matches_host():
    """Four chunks of 8 points: valid 0 returns the accumulator, valid k
    the accumulator plus the MSM over the first k chunks (later words are
    nonzero and ignored); shapes off the chunk grid are refused."""
    pts = F.from_raw(JBulletproofGens(32).G_raw(32))
    rows = scvec.from_wide_bytes(np.random.RandomState(32).bytes(64 * 32))
    rows[:2] = scvec.from_ints([0, L - 1])
    words = ck.w4_words(rows, "cpu")
    B = PedersenGens.default().B
    acc = F.from_points([B])
    host = F.to_points(pts)
    sc = scvec.to_scalars(rows)
    for valid in (0, 1, 3, 4):
        got = F.to_points(cc.msm_grid_local(pts, words, acc, valid, 8))[0]
        n = 8 * valid
        assert got == multiscalar_mul(sc[:n], host[:n]) + B, valid
    for valid, chunk in ((5, 8), (-1, 8), (1, 5)):
        with pytest.raises(ValueError):
            cc.msm_grid_local(pts, words, acc, valid, chunk)
