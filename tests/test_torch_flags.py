"""The port's one route, and the kernels of the reference's other route
flags, against the JAX package.

* Kernel level: the plain versions of ``fold_c``, ``fold_c_comb`` and
  ``msm_grid`` equal the JAX package's TPU kernels run once each under
  ``pallas_call(interpret=True)`` at the minimal capacity geometry (as
  tests/test_kernel_flags_interpret.py runs them): ``fold_grid_c`` with
  one output chunk and the breakpoint inside it, ``fold_grid_c_comb``
  with h = 1 (four chunks), both on 192 lanes of each output chunk (the
  chunk's ends and the breakpoint's neighbourhood: the plain versions
  fold those lanes' points), ``msm_grid_acc`` over one chunk at a chunk
  offset, with every eighth word row nonzero and a chained accumulator;
  and the host ``scalar_mul`` / ``multiscalar_mul`` on a subset, with the
  combined fold's breakpoint at either end, ``msm_grid`` chained at both
  ends of its points, and ``msm_win``'s wrap walk as two chained walks and
  as ``msm_win_pair``'s R.  (``msm_win``'s plain version is held against
  ``msm_win_dyn``'s straight and wrap walks in tests/test_torch_comb.py,
  beside the interpret-mode walker that file already runs.)  The port's
  constant-fold words are the rows of the reference's ``_c_fold_words``.
  No backend path launches ``msm_win``, ``msm_grid`` or ``fold_c_comb``:
  these tests are what holds them.
* Proof level: on the one route, at padded n = 2 * COMB_MIN_N (the shape
  of padded n = 4096), on the chunk-list route, and for a batch of two
  through ``prove_provers`` unfrozen and frozen (the flotilla), the
  port's ``TorchBackend("cpu")`` proof is byte-identical to the JAX
  package's host proof of the same seeded circuit.  The grid thresholds
  are lowered as tests/test_torch_backend.py lowers them, so that every
  branch runs at 64 multipliers, and each geometry's kernel calls are
  counted exactly, for a proof and for a verify.  The ``BPTPU_*``
  variables change none of them, and ``Route`` has no fields.
* The port's ``NativeBackend`` gives the JAX package's bytes.

CPU tensors route to the plain versions.  Tolerance: exact (equal
points, equal words, equal bytes).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from bulletproofs_r1cs_gadgets_tpu.core.pedersen import (
    BulletproofGens as JBulletproofGens,
)
from bulletproofs_r1cs_gadgets_tpu.core.pedersen import (
    PedersenGens as JPedersenGens,
)
from bulletproofs_r1cs_gadgets_tpu.core.scalar import Scalar as JScalar
from bulletproofs_r1cs_gadgets_tpu.ops import chunks as jck
from bulletproofs_r1cs_gadgets_tpu.ops import pallas_curve as pc
from bulletproofs_r1cs_gadgets_tpu.ops.field import STORE, limbs_to_int
from bulletproofs_r1cs_gadgets_tpu.utils.constants import L, P
from bulletproofs_r1cs_gadgets_tpu_torch import (
    BulletproofGens,
    PedersenGens,
    R1CSProof,
    Route,
    Scalar,
    TorchBackend,
    VerificationError,
    multiscalar_mul,
    prove_provers,
    scvec,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F
from bulletproofs_r1cs_gadgets_tpu_torch.ops import torch_backend as tb
from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import NativeBackend
from test_torch_backend import (
    CIRCUITS,
    COMB_CHUNK,
    WALKER_MIN_N,
    _host_proof,
    count_calls,
)

# The plain versions run many small tensor ops: intra-op threads gain
# nothing there and contend with the other test workers' processes.
torch.set_num_threads(1)

_C = jck.CHUNK
BP = 700  # the breakpoint, inside the first output chunk
CONSTS = [int.from_bytes(np.random.RandomState(s).bytes(32), "little") % L
          for s in (11, 12, 13, 14)]


# ------------------------------------------------------------ kernels
def _big_points(big, chunk: int, count: int = 1) -> list[tuple[int, ...]]:
    """Points of `count` 2048-point chunks of a capacity array from
    `chunk` on, as (X, Y, Z) ints."""
    lanes = slice(chunk * pc.LAN_BLOCK, (chunk + count) * pc.LAN_BLOCK)
    blk = np.asarray(big[:, :, lanes])  # (92, SUB, count * LAN)
    cols = blk.reshape(pc.ROWS, pc.SUB, count, pc.LAN_BLOCK)
    cols = cols.transpose(2, 1, 3, 0).reshape(count * _C, 4, STORE)
    return [tuple(limbs_to_int(c[k]) % P for k in range(3)) for c in cols]


def _same(got: torch.Tensor, want) -> bool:
    """Port points (a tensor) equal JAX points ((X, Y, Z) ints): equal
    Edwards points, X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1."""
    pts = F.to_points(got)
    assert len(pts) == len(want)
    return all(
        (p.X * z - x * p.Z) % P == 0 and (p.Y * z - y * p.Z) % P == 0
        for p, (x, y, z) in zip(pts, want)
    )


@pytest.fixture(scope="module")
def jax_kernels(request):
    """ONE interpret-mode run of each JAX kernel over the first 8192
    generators (four chunks)."""
    from jax.experimental import pallas as pl
    import jax.numpy as jnp

    from bulletproofs_r1cs_gadgets_tpu.ops.pallas_backend import PallasBackend

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    fns = (pc.fold_grid_c, pc.fold_grid_c_comb, pc.msm_grid_acc)
    for fn in fns:
        fn.clear_cache()

    def fin():
        pl.pallas_call = orig
        for fn in fns:
            fn.clear_cache()

    request.addfinalizer(fin)
    n = 4 * _C
    share = JBulletproofGens(n).share(0)
    big = PallasBackend()._gens_big(share, n, "G")
    cA, cB, cC, cD = (JScalar(c) for c in CONSTS)
    fold = jck.fold_big_c(big, 1, BP, cA, cB, donate=False)
    # fold_grid_c_comb donates its input: give it a copy
    comb = jck.fold_big_c_comb(jnp.array(big, copy=True), 1, BP,
                               (cA, cB), (cC, cD))
    B = JPedersenGens.default().B
    acc = jck.msm_grid(big, jck.grid_words(_grid_rows(), 1), 1, offset=2,
                       acc=jck.broadcast_chunk(B))
    (tot,) = jck.fetch_points([acc])
    return {
        "raw": share.G_raw(n),
        "fold": _big_points(fold, 0),
        "comb": _big_points(comb, 0, 2),
        "grid": (tot.X, tot.Y, tot.Z),
    }


def _grid_rows() -> np.ndarray:
    """One chunk of scalars, nonzero in every eighth row (0, 1 and L - 1
    among them): the plain ladder skips zero rows, the TPU kernel walks
    them."""
    rows = np.zeros((_C, 4), np.uint64)
    live = scvec.from_wide_bytes(np.random.RandomState(21).bytes(64 * _C // 8))
    live[:3] = scvec.from_ints([0, 1, L - 1])
    rows[::8] = live
    return rows


# the fold lanes checked against the TPU kernels: both ends of the output
# chunk and the breakpoint's neighbourhood
LANES = sorted({*range(64), *range(BP - 32, BP + 32), *range(_C - 64, _C)})


def _lanes(pts: torch.Tensor, v: int) -> torch.Tensor:
    """[P[LANES] | P[LANES + v]]: the inputs of the LANES outputs of a fold
    of 2v points."""
    idx = torch.tensor(LANES)
    return torch.cat([pts[idx], pts[idx + v]])


_SUB_BP = sum(1 for i in LANES if i < BP)


def _c_words(*pairs) -> torch.Tensor:
    return ck.c_fold_words(
        [tuple(Scalar(c) for c in pair) for pair in pairs], "cpu"
    )


@pytest.mark.kernelmath
def test_fold_c_plain_matches_tpu_kernel_and_host(jax_kernels):
    pts = _lanes(F.from_raw(jax_kernels["raw"][: 2 * _C]), _C)
    got = cc.fold_c(pts, _c_words(CONSTS[:2]), _SUB_BP)
    assert got.shape == (len(LANES), 4, 8)
    assert _same(got, [jax_kernels["fold"][i] for i in LANES])
    host = F.to_points(pts)
    v = len(LANES)
    for j in (0, _SUB_BP - 1, _SUB_BP, v - 1):
        c = Scalar(CONSTS[0] if LANES[j] < BP else CONSTS[1])
        assert F.to_points(got[j : j + 1])[0] == (
            host[j] + host[j + v].scalar_mul(c)), LANES[j]


@pytest.mark.kernelmath
def test_fold_c_comb_plain_matches_tpu_kernel(jax_kernels):
    pts = F.from_raw(jax_kernels["raw"])
    sides = torch.cat([_lanes(pts[: 2 * _C], _C), _lanes(pts[2 * _C :], _C)])
    got = cc.fold_c_comb(sides, _c_words(CONSTS[:2], CONSTS[2:]), _SUB_BP)
    want = jax_kernels["comb"]
    assert _same(got, [want[i] for i in LANES] + [want[_C + i] for i in LANES])


@pytest.mark.kernelmath
def test_msm_grid_plain_matches_tpu_kernel(jax_kernels):
    pts = F.from_raw(jax_kernels["raw"])
    acc = F.from_points([PedersenGens.default().B])
    got = cc.msm_grid(pts, ck.w4_words(_grid_rows(), "cpu"), acc, poff=2 * _C)
    assert _same(got, [jax_kernels["grid"]])


def test_fold_c_edges_in_place_and_host():
    """Constants 0, 1 and L - 1 (the identity, P[i] + P[i+v], P[i] -
    P[i+v]), a breakpoint at either end, and the in-place form."""
    n = 8
    pts = F.from_raw(JBulletproofGens(2 * n).G_raw(2 * n))
    host = F.to_points(pts)
    for pair, bp in (((0, 1), 3), ((L - 1, 1), 0), ((1, L - 1), n)):
        got = F.to_points(cc.fold_c(pts, _c_words(pair), bp))
        for i in range(n):
            c = Scalar(pair[0] if i < bp else pair[1])
            assert got[i] == host[i] + host[i + n].scalar_mul(c), (pair, i)
    words = _c_words(CONSTS[:2])
    want = cc.fold_c(pts, words, 5)
    own = pts.clone()
    assert cc.fold_c(own, words, 5, out=own[:n]).data_ptr() == own.data_ptr()
    assert torch.equal(own[:n], want)
    with pytest.raises(ValueError):
        cc.fold_c(pts, _c_words(CONSTS[:2], CONSTS[2:]), 5)  # two sides
    # the combined fold is both sides' folds
    comb_words = _c_words(CONSTS[:2], CONSTS[2:])
    both = cc.fold_c_comb(pts, comb_words, 2)
    half = n // 2
    assert torch.equal(both[:half], cc.fold_c(pts[:n], comb_words[:1], 2))
    assert torch.equal(both[half:], cc.fold_c(pts[n:], comb_words[1:], 2))


def test_msm_grid_subset_matches_host():
    pts = F.from_raw(JBulletproofGens(64).G_raw(64))
    rows = _grid_rows()[:16]
    acc = F.identity_points(1)
    got = F.to_points(cc.msm_grid(pts, ck.w4_words(rows, "cpu"), acc, poff=5))
    assert got[0] == multiscalar_mul(scvec.to_scalars(rows),
                                     F.to_points(pts[5:21]))
    with pytest.raises(ValueError):
        cc.msm_grid(pts, ck.w4_words(rows, "cpu"), acc, poff=50)


def test_c_fold_words_are_the_reference_rows():
    """Each side's two rows are the per-point rows of ``_c_fold_words``
    (``_c_fold_words_comb``) below and from the breakpoint, and decode to
    the constants."""
    cA, cB, cC, cD = CONSTS

    def point_rows(words, k):  # capacity (8, SUB, lanes) -> (k * CHUNK, 8)
        w = np.asarray(words)[:, :, : k * pc.LAN_BLOCK]
        w = w.reshape(8, pc.SUB, k, pc.LAN_BLOCK).transpose(2, 1, 3, 0)
        return w.reshape(k * _C, 8)

    ref = point_rows(jck._c_fold_words(JScalar(cA), JScalar(cB), BP, 1), 1)
    got = _c_words((cA, cB)).numpy()
    assert got.shape == (1, 2, 8)
    assert (ref[:BP] == got[0, 0]).all() and (ref[BP:] == got[0, 1]).all()
    ref = point_rows(jck._c_fold_words_comb(
        JScalar(cA), JScalar(cB), JScalar(cC), JScalar(cD), BP, 1), 2)
    got = _c_words((cA, cB), (cC, cD)).numpy()
    for s in range(2):
        side = ref[s * _C : (s + 1) * _C]
        assert (side[:BP] == got[s, 0]).all() and (side[BP:] == got[s, 1]).all()
    for row, c in zip(got.reshape(4, 8), CONSTS):
        assert cs.decode_w4(row) % L == c




def _rows(n: int, seed: int) -> np.ndarray:
    """n random scalar rows, the first three 0, 1 and L - 1."""
    rows = scvec.from_wide_bytes(np.random.RandomState(seed).bytes(64 * n))
    rows[:3] = scvec.from_ints([0, 1, L - 1])
    return rows


@pytest.mark.parametrize("bp", [0, 8], ids=["breakpoint-0", "breakpoint-end"])
def test_fold_c_comb_breakpoint_at_either_end_matches_host(bp):
    """Both sides of the combined fold against host arithmetic with the
    breakpoint at 0 (every output takes a side's second constant) and at
    v (its first)."""
    v = 8
    pts = F.from_raw(JBulletproofGens(4 * v).G_raw(4 * v))
    host = F.to_points(pts)
    got = F.to_points(
        cc.fold_c_comb(pts, _c_words(CONSTS[:2], CONSTS[2:]), bp))
    for s in range(2):
        side = host[2 * v * s : 2 * v * (s + 1)]
        for i in range(v):
            c = Scalar(CONSTS[2 * s + (0 if i < bp else 1)])
            assert got[s * v + i] == side[i] + side[i + v].scalar_mul(c), \
                (s, i)


@pytest.mark.parametrize("poff", [0, 48], ids=["first-points", "last-points"])
def test_msm_grid_chained_at_either_end_matches_host(poff):
    """``msm_grid`` from a non-identity accumulator over the first and
    the last 16 of 64 points (the view ending at the tensor's end)."""
    pts = F.from_raw(JBulletproofGens(64).G_raw(64))
    rows = _rows(16, 22)
    B = PedersenGens.default().B
    got = F.to_points(cc.msm_grid(pts, ck.w4_words(rows, "cpu"),
                                  F.from_points([B]), poff=poff))
    assert got[0] == B + multiscalar_mul(scvec.to_scalars(rows),
                                         F.to_points(pts[poff : poff + 16]))


def test_msm_win_wrap_walk_is_two_chained_walks_and_the_pair_r():
    """A combined round's R (``ck.comb_walks``' second walk, which wraps
    from rows [0, n) to [3n, 4n)) as one ``msm_win`` wrap walk, as two
    chained straight walks and as ``msm_win_pair``'s second row: the host
    MSM; its L walk is the pair's first row."""
    n = 8
    pts = F.from_raw(JBulletproofGens(4 * n).G_raw(4 * n))
    tbl = cc.table_w4(pts)
    rows = _rows(4 * n, 23)
    words = ck.w4_words(rows, "cpu")
    ident = F.identity_points(1)
    walk_L, walk_R = ck.comb_walks(n)
    wrap = cc.msm_win(tbl, words, ident, *walk_R)
    chained = cc.msm_win(tbl, words, ident, n, 0, 2 * n)
    chained = cc.msm_win(tbl, words, chained, n, 3 * n, 3 * n)
    pair = cc.msm_win_pair(tbl, words, F.identity_points(2), (walk_L, walk_R))
    sc, P_ = scvec.to_scalars(rows), F.to_points(pts)
    want = (multiscalar_mul(sc[2 * n : 3 * n], P_[:n])
            + multiscalar_mul(sc[3 * n :], P_[3 * n :]))
    got = F.to_points(torch.cat([wrap, chained, pair[1:]]))
    assert got == [want] * 3
    assert F.to_points(cc.msm_win(tbl, words, ident, *walk_L)) == \
        F.to_points(pair[:1])


# --------------------------------------------------------------- proofs
CIRCUIT = "bound"  # 64 padded multipliers
# Prove-only kernel calls of the one route on CIRCUIT with COMB_MIN_N = 8,
# walker_min_n = 1, frozen_max_side = 8: round 1 at n = 32 over the shared
# tables, the combined rounds at n = 16 and 8, the tail round at n = 4
# (the freeze), two frozen rounds.
_W5_ROUND1 = {"table_w5": 2, "msm_win5": 9}
ROUTE_CALLS = dict(_W5_ROUND1, fold_w3h=2, table_w4=2, msm_win_pair=2,
                   fold_w3h_comb=2, msm_w4=2, msm_w4_pair=2)
# The reference's route flags, every one of which the port ignores.
REFERENCE_FLAGS = ("WINMSM", "W3H", "WRAPMSM", "PAIRWALK", "FLOTILLA", "W5",
                   "TBLTIER")


def _prove_route(monkeypatch):
    """(commitments, proof, kernel calls) of CIRCUIT on the one route
    with the thresholds above, on a fresh backend."""
    monkeypatch.setattr(tb, "COMB_MIN_N", COMB_CHUNK)
    calls = count_calls(monkeypatch, tuple(cc.LAUNCHES))
    backend = TorchBackend("cpu", min_device_n=1, frozen_max_side=8,
                           walker_min_n=1, route=Route())
    comms, proof = CIRCUITS[CIRCUIT].prove(backend)
    return comms, proof, {k: v for k, v in calls.items() if v}


# the reference's name for the combination of its flags the port runs
@pytest.mark.parametrize("combo", ["default"])
def test_route_proof_matches_host(combo, monkeypatch):
    comms_ref, ref = _host_proof(CIRCUIT)
    comms, proof, calls = _prove_route(monkeypatch)
    assert comms == comms_ref
    assert proof.to_bytes() == ref.to_bytes()
    assert calls == ROUTE_CALLS
    cs.check_route(combo, calls)  # what chip_smoke.py holds the card to


def test_route_has_no_fields_and_the_environment_picks_nothing(monkeypatch):
    """``Route`` has no fields, and with every one of the reference's
    ``BPTPU_*`` route flags off in the environment a proof still launches
    the one route's kernels and gives the host's bytes."""
    assert dataclasses.fields(Route) == ()
    with pytest.raises(TypeError):
        Route(w5=False)
    for name in REFERENCE_FLAGS:
        monkeypatch.setenv(f"BPTPU_{name}", "0")
    comms_ref, ref = _host_proof(CIRCUIT)
    comms, proof, calls = _prove_route(monkeypatch)
    assert comms == comms_ref and proof.to_bytes() == ref.to_bytes()
    assert calls == ROUTE_CALLS


def test_combined_off_route_matches_host(monkeypatch):
    """chip_smoke.py's chunk-list route (``combined_off``: COMB_MIN_N above
    the padded size): round 1 over the shared tables, then ``msm_w4``
    segments and ``fold_bits`` folds (n = 32, 16, 8), the freeze at 4."""
    comms_ref, ref = _host_proof(CIRCUIT)
    calls = count_calls(monkeypatch, tuple(cc.LAUNCHES))
    backend = TorchBackend("cpu", min_device_n=1, frozen_max_side=8,
                           walker_min_n=1)
    with cs.combined_off():
        comms, proof = CIRCUITS[CIRCUIT].prove(backend)
    assert tb.COMB_MIN_N == tb.CHUNK
    assert comms == comms_ref and proof.to_bytes() == ref.to_bytes()
    ran = {k: v for k, v in calls.items() if v}
    assert ran == dict(_W5_ROUND1, fold_bits=6, msm_w4=6, msm_w4_pair=2)
    cs.check_route("combined off", ran, combined=False)
    # the default route's check refuses these counts
    missing = r"not launched \['fold_w3h', 'fold_w3h_comb', 'msm_win_pair'"
    with pytest.raises(AssertionError, match=missing):
        cs.check_route("default", ran)


def test_padded_two_chunks_folds_round_one_with_fold_c(monkeypatch):
    """Padded n = 2 * COMB_MIN_N (4096 at the reference's CHUNK): round 1
    walks the shared tables, then folds each side with ``fold_c``
    (pallas_backend.py:1069-1076), not ``fold_bits``; no combined
    rounds."""
    comms_ref, ref = _host_proof(CIRCUIT)
    monkeypatch.setattr(tb, "COMB_MIN_N", 32)
    calls = count_calls(monkeypatch, ("fold_c", "fold_bits", "msm_win5",
                                      "fold_w3h", "msm_win_pair"))
    backend = TorchBackend("cpu", min_device_n=1, frozen_max_side=8,
                           walker_min_n=1)
    comms, proof = CIRCUITS[CIRCUIT].prove(backend)
    assert comms == comms_ref and proof.to_bytes() == ref.to_bytes()
    # fold_bits at n = 16 and 8 (the freeze at 4)
    assert calls == {"fold_c": 2, "fold_bits": 4, "msm_win5": 9,
                     "fold_w3h": 0, "msm_win_pair": 0}


# Every kernel call of a proof of CIRCUIT at the default COMB_MIN_N (no
# combined rounds at 64 multipliers), by the sizes that choose the
# branches: (frozen_max_side, walker_min_n, calls).  Phase 1 is three
# msm_w4 launches below the walker range and five msm_win5 walks over two
# table_w5 tables in it; the IPP has six rounds, n = 32 .. 1.
GEOMETRY_CALLS = {
    # frozen from round 1: an msm_w4_pair launch a round
    "frozen-from-round-1": (1024, WALKER_MIN_N,
                            {"msm_w4": 3, "msm_w4_pair": 6}),
    # msm_w4 per side at n = 32, 16, 8, fold_bits at 32 and 16, the freeze
    # at 8, then three frozen rounds
    "chunk-list-then-freeze": (16, WALKER_MIN_N,
                               {"msm_w4": 9, "fold_bits": 4,
                                "msm_w4_pair": 3}),
    # msm_w4 per side and fold_bits in every round
    "never-frozen": (0, WALKER_MIN_N, {"msm_w4": 15, "fold_bits": 12}),
    # round 1 over the shared tables, then as chunk-list-then-freeze
    "walker-then-freeze": (16, 1, {"table_w5": 2, "msm_win5": 9,
                                   "msm_w4": 4, "fold_bits": 4,
                                   "msm_w4_pair": 3}),
}


@pytest.mark.parametrize("geometry", list(GEOMETRY_CALLS))
def test_one_route_launches_by_size(geometry, monkeypatch):
    max_side, walker_min_n, want = GEOMETRY_CALLS[geometry]
    comms_ref, ref = _host_proof(CIRCUIT)
    calls = count_calls(monkeypatch, tuple(cc.LAUNCHES))
    backend = TorchBackend("cpu", min_device_n=1, frozen_max_side=max_side,
                           walker_min_n=walker_min_n)
    comms, proof = CIRCUITS[CIRCUIT].prove(backend)
    assert comms == comms_ref and proof.to_bytes() == ref.to_bytes()
    assert {k: v for k, v in calls.items() if v} == want


# Every kernel call of a verification of CIRCUIT: in the walker range the
# row kernels build G/H's words and two msm_win5 walks take them between
# the head's and the tail's msm_w4; below it one msm_w4 launch.
VERIFY_CALLS = {
    "walker-range": (1, {"sc_powers": 3, "tape_flatten": 1, "tape_sums": 1,
                         "gh_rows": 1, "table_w5": 2, "msm_win5": 2,
                         "msm_w4": 2}),
    "below-walker-range": (WALKER_MIN_N, {"msm_w4": 1}),
}


@pytest.mark.parametrize("where", list(VERIFY_CALLS))
def test_one_route_verify_launches_by_size(where, monkeypatch):
    walker_min_n, want = VERIFY_CALLS[where]
    comms, ref = _host_proof(CIRCUIT)
    backend = TorchBackend("cpu", min_device_n=1, walker_min_n=walker_min_n)
    calls = count_calls(monkeypatch, tuple(cc.LAUNCHES))
    CIRCUITS[CIRCUIT].verify(comms, R1CSProof.from_bytes(ref.to_bytes()),
                             backend)
    assert {k: v for k, v in calls.items() if v} == want


@pytest.mark.parametrize("frozen, lane_rounds", [(False, 0), (True, 2)])
def test_batch_flotilla_off_and_on_matches_host(frozen, lane_rounds,
                                                monkeypatch):
    """Two provers of the same seeded circuit through ``prove_provers``
    (as bench.py's gate batches three): two copies of the host proof.
    Frozen (side cap 8), each job freezes at n = 4, so rounds n = 2 and 1
    are frozen: one ``msm_lane`` per round for both jobs (the flotilla).
    Never frozen (side cap 0), every round is each job's own ``msm_w4``
    pair and ``fold_bits`` folds: no ``msm_lane``, no ``msm_w4_pair``."""
    comms_ref, ref = _host_proof(CIRCUIT)
    monkeypatch.setattr(tb, "COMB_MIN_N", COMB_CHUNK)
    calls = count_calls(monkeypatch, ("msm_lane", "msm_w4_pair"))
    circ = CIRCUITS[CIRCUIT]
    built = [circ.build() for _ in range(2)]
    backend = TorchBackend("cpu", min_device_n=1,
                           frozen_max_side=8 if frozen else 0,
                           walker_min_n=1)
    gens = BulletproofGens(circ.capacity)
    proofs = prove_provers([p for _, p in built], gens, backend=backend,
                           host_workers=1)
    assert all(c == comms_ref for c, _ in built)
    assert [p.to_bytes() for p in proofs] == [ref.to_bytes()] * 2
    assert calls == {"msm_lane": lane_rounds, "msm_w4_pair": 0}


def test_native_backend_matches_the_jax_package():
    """The port's copy of the single-core C++ backend gives the JAX host
    engine's bytes, and the JAX NativeBackend's where that library
    loaded."""
    from bulletproofs_r1cs_gadgets_tpu.ops import native_backend as jnb

    comms_ref, ref = _host_proof(CIRCUIT)
    comms, got = CIRCUITS[CIRCUIT].prove(NativeBackend())
    assert comms == comms_ref and got.to_bytes() == ref.to_bytes()
    if jnb.native_available():
        _, want = CIRCUITS[CIRCUIT].prove(jnb.NativeBackend(), pkg="jax")
        assert got.to_bytes() == want.to_bytes()
