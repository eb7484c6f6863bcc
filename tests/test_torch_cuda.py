"""The port's kernels and backend on an NVIDIA GPU (skipped without one).

This file imports no JAX, so it also runs where the port runs:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Each kernel is held against its plain torch version on the same CUDA
tensors (the window walkers also at step counts around their block sizes
and at edge walks, on subsets against the host MSM; the walkers'
carry-chain multiply and squaring against ``fe_mul`` on edge operands),
and a proof, a proof on the combined IPP route (its threshold
lowered) and a batch of three proofs (``prove_provers``) through
``TorchBackend("cuda")`` against the host engine's bytes; the equivalence
gate's depth-8 proof against ``NativeBackend``'s bytes; the
verifier's G/H row kernels against their plain versions and the host's
rows at VSMT-2 depth 4 and VSMT-4 depth 128, on edge shapes, and a
batch's rows summed over 2 and 8 row sets and over two padded sizes.  On a
machine with two cards: a two-shard ``ShardedWalkMsm`` over cuda:0 and
cuda:1, and a backend on cuda:1 driven from the main thread (cuda:0
current) and from pool threads, byte-identical to cuda:0 (skipped on one
card).  Tolerance: exact (equal points, equal table words, equal bytes).
"""

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu_torch import (
    BulletproofGens,
    L,
    PedersenGens,
    Prover,
    R1CSProof,
    Scalar,
    TorchBackend,
    Transcript,
    VerificationError,
    Verifier,
    batch_verify,
    multiscalar_mul,
    prove_provers,
    prove_provers_devices,
    scvec,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import build
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F
from bulletproofs_r1cs_gadgets_tpu_torch.ops import torch_backend as tb
from bulletproofs_r1cs_gadgets_tpu_torch.parallel.sharded_fast import (
    ShardedWalkMsm,
)
from test_torch_smul_pointwise import pointwise_inputs
from test_torch_walker import host_walk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _points(n: int, seed: int):
    rng = np.random.RandomState(seed)
    B = PedersenGens.default().B
    return [
        B.scalar_mul(Scalar(int.from_bytes(rng.bytes(31), "little") + 1))
        for _ in range(n)
    ]


def _scalar_rows(n: int, seed: int) -> np.ndarray:
    rows = scvec.from_wide_bytes(np.random.RandomState(seed).bytes(64 * n))
    rows[:3] = scvec.from_ints([0, 1, L - 1])
    return rows


def test_kernels_match_plain_on_card(cuda_device):
    dev = cuda_device
    pts = F.from_points(_points(300, 70), dev)
    words = ck.w4_words(_scalar_rows(300, 71), dev)
    words[3] = -0x77777778  # 0x88888888: eight digits of -8
    acc = F.from_points(_points(1, 72), dev)
    before = dict(cc.LAUNCHES)
    assert F.to_points(cc.msm_w4(pts, words, acc)) == \
        F.to_points(cc.msm_w4_plain(pts, words, acc))
    acc2 = torch.cat([acc, acc])
    for lo, hi in ((0, 77), (150, 0), (150, 150)):
        assert F.to_points(cc.msm_w4_pair(pts, words, acc2, 150, lo, hi)) \
            == F.to_points(
                cc.msm_w4_pair_plain(pts, words, acc2, 150, lo, hi))
    wl = ck.fold_words(_scalar_rows(150, 73), dev)
    wr = ck.fold_words(_scalar_rows(150, 74)[::-1].copy(), dev)
    assert F.to_points(cc.fold_bits(pts[:150], pts[150:], wl, wr)) == \
        F.to_points(cc.fold_bits_plain(pts[:150], pts[150:], wl, wr))
    assert {k: cc.LAUNCHES[k] - before[k] for k in before} == {
        "msm_w4": 1, "msm_w4_pair": 3, "fold_bits": 1,
        "table_w5": 0, "msm_win5": 0, "msm_lane": 0,
        "fold_w3h": 0, "fold_w3h_comb": 0, "table_w4": 0, "msm_win_pair": 0,
        "fold_c": 0, "fold_c_comb": 0, "msm_win": 0, "msm_grid": 0,
        "msm_grid_local": 0, "padd": 0, "pdbl": 0, "smul_lanes": 0,
        "msm_block_totals": 0, "msm_chunk_acc": 0, "fold_grid": 0,
        "mul_fp": 0, "mul_fq": 0, "poseidon_permute": 0, "poseidon_chain": 0,
        "sc_powers": 0, "tape_flatten": 0, "tape_sums": 0, "gh_rows": 0,
    }


def test_w5_and_lane_kernels_match_plain_on_card(cuda_device):
    dev = cuda_device
    pts = F.from_points(_points(300, 80), dev)
    before = dict(cc.LAUNCHES)
    tbl = cc.table_w5(pts)
    assert torch.equal(tbl, cc.table_w5_plain(pts))
    rows = _scalar_rows(300, 81)
    words = ck.w5_words(rows, dev)
    words[3] = 0x10101010  # code 16 in every byte: digits of -16
    chain = F.from_points(_points(1, 82), dev)
    for kw in (dict(v=300), dict(v=120, poff=7, woff=3),
               dict(v=250, poff=40, split=200, poff2=10)):
        got = cc.msm_win5(tbl, words, chain, **kw)
        sp = kw.get("split", kw["v"])
        plain = cc.msm_win5_plain(
            tbl, words, chain, kw["v"], kw.get("poff", 0), kw.get("woff", 0),
            sp, kw.get("poff2", kw.get("poff", 0)),
        )
        assert F.to_points(got) == F.to_points(plain)
    w4 = ck.w4_words(_scalar_rows(300, 83), dev)
    w4[100:200] = 0  # an all-zero segment
    got = F.to_points(cc.msm_lane(pts, w4, 3))
    assert got == F.to_points(cc.msm_lane_plain(pts, w4, 3))
    assert got[1].is_identity()
    assert {k: cc.LAUNCHES[k] - before[k] for k in before} == {
        "msm_w4": 0, "msm_w4_pair": 0, "fold_bits": 0,
        "table_w5": 1, "msm_win5": 3, "msm_lane": 1,
        "fold_w3h": 0, "fold_w3h_comb": 0, "table_w4": 0, "msm_win_pair": 0,
        "fold_c": 0, "fold_c_comb": 0, "msm_win": 0, "msm_grid": 0,
        "msm_grid_local": 0, "padd": 0, "pdbl": 0, "smul_lanes": 0,
        "msm_block_totals": 0, "msm_chunk_acc": 0, "fold_grid": 0,
        "mul_fp": 0, "mul_fq": 0, "poseidon_permute": 0, "poseidon_chain": 0,
        "sc_powers": 0, "tape_flatten": 0, "tape_sums": 0, "gh_rows": 0,
    }


def test_combined_layout_kernels_match_plain_on_card(cuda_device):
    dev = cuda_device
    pts = F.from_points(_points(256, 90), dev)
    before = dict(cc.LAUNCHES)
    pairs = [ck.half_gcd_split(c, L) for c in (12345, L - 7)]
    for pr, bp_ in ((pairs, 50), ([(0, 1), (1, -1)], 100)):
        words = ck.w3h_fold_words([pr], dev)
        assert F.to_points(cc.fold_w3h(pts, words, bp_)) == \
            F.to_points(cc.fold_w3h_plain(pts, words, bp_))
    words = ck.w3h_fold_words([pairs, pairs[::-1]], dev)
    got = cc.fold_w3h_comb(pts, words, 30)
    assert F.to_points(got) == F.to_points(cc.fold_w3h_comb_plain(pts, words, 30))
    assert torch.equal(got[:64], cc.fold_w3h(pts[:128], words[:1], 30))
    tbl = cc.table_w4(pts)
    assert torch.equal(tbl, cc.table_w4_plain(pts))
    assert torch.equal(cc.table_w4(pts[:100], out=tbl.clone()), tbl[:100])
    w4 = ck.w4_words(_scalar_rows(256, 91), dev)
    w4[3] = -0x77777778
    chain2 = F.from_points(_points(2, 92), dev)
    for walks in (ck.comb_walks(64), ((100, 20, 5, 60, 150), (3, 0, 0, 3, 0))):
        assert F.to_points(cc.msm_win_pair(tbl, w4, chain2, walks)) == \
            F.to_points(cc.msm_win_pair_plain(tbl, w4, chain2, walks))
    assert {k: cc.LAUNCHES[k] - before[k] for k in before} == {
        "msm_w4": 0, "msm_w4_pair": 0, "fold_bits": 0,
        "table_w5": 0, "msm_win5": 0, "msm_lane": 0,
        "fold_w3h": 3, "fold_w3h_comb": 1, "table_w4": 2, "msm_win_pair": 2,
        "fold_c": 0, "fold_c_comb": 0, "msm_win": 0, "msm_grid": 0,
        "msm_grid_local": 0, "padd": 0, "pdbl": 0, "smul_lanes": 0,
        "msm_block_totals": 0, "msm_chunk_acc": 0, "fold_grid": 0,
        "mul_fp": 0, "mul_fq": 0, "poseidon_permute": 0, "poseidon_chain": 0,
        "sc_powers": 0, "tape_flatten": 0, "tape_sums": 0, "gh_rows": 0,
    }


def test_route_flag_kernels_match_plain_on_card(cuda_device):
    """fold_c (random and edge constants, in place), fold_c_comb, msm_win
    (straight and wrap walks) and msm_grid (at an offset, chained)."""
    dev = cuda_device
    pts = F.from_points(_points(256, 100), dev)
    before = dict(cc.LAUNCHES)
    consts = [(Scalar(12345), Scalar(L - 7)), (Scalar(0), Scalar(1)),
              (Scalar(L - 1), Scalar(3))]
    for pair, bp_ in zip(consts, (50, 100, 0)):
        words = ck.c_fold_words([pair], dev)
        assert F.to_points(cc.fold_c(pts, words, bp_)) == \
            F.to_points(cc.fold_c_plain(pts, words, bp_))
    own = pts.clone()
    words = ck.c_fold_words([consts[0]], dev)
    want = cc.fold_c(pts, words, 50)
    assert torch.equal(cc.fold_c(own, words, 50, out=own[:128]), want)
    words = ck.c_fold_words(consts[:2], dev)
    got = cc.fold_c_comb(pts, words, 30)
    assert F.to_points(got) == F.to_points(cc.fold_c_comb_plain(pts, words, 30))
    assert torch.equal(got[:64], cc.fold_c(pts[:128], words[:1], 30))
    tbl = cc.table_w4(pts)
    w4 = ck.w4_words(_scalar_rows(256, 101), dev)
    w4[3] = -0x77777778  # 0x88888888: eight digits of -8
    chain = F.from_points(_points(1, 102), dev)
    for walk in ((256, 0, 0, 256, 0), (100, 20, 5, 60, 150)):
        assert F.to_points(cc.msm_win(tbl, w4, chain, *walk)) == \
            F.to_points(cc.msm_win_plain(tbl, w4, chain, *walk))
    w = w4[:200].contiguous()
    assert F.to_points(cc.msm_grid(pts, w, chain, 40)) == \
        F.to_points(cc.msm_grid_plain(pts, w, chain, 40))
    assert {k: cc.LAUNCHES[k] - before[k] for k in before} == {
        "msm_w4": 0, "msm_w4_pair": 0, "fold_bits": 0,
        "table_w5": 0, "msm_win5": 0, "msm_lane": 0,
        "fold_w3h": 0, "fold_w3h_comb": 0, "table_w4": 1, "msm_win_pair": 0,
        "fold_c": 6, "fold_c_comb": 1, "msm_win": 2, "msm_grid": 1,
        "msm_grid_local": 0, "padd": 0, "pdbl": 0, "smul_lanes": 0,
        "msm_block_totals": 0, "msm_chunk_acc": 0, "fold_grid": 0,
        "mul_fp": 0, "mul_fq": 0, "poseidon_permute": 0, "poseidon_chain": 0,
        "sc_powers": 0, "tape_flatten": 0, "tape_sums": 0, "gh_rows": 0,
    }


# ---- the window walkers' geometry: step counts around a thread row (128)
# and around pass 1's blocks at the smallest and at a full-card size
WALK_STEPS = (1, 2, 127, 128, 129, 511, 512, 513, 7679, 7680, 7681)
WALK_N = 8192 + 64
ALL_M16 = 0x10101010  # a w5 word of four -16 digits (code 16 per byte)
ALL_M8 = -0x77777778  # 0x88888888: a w4 word of eight -8 digits


def _walk_inputs(dev, bits: int, seed: int):
    """A WALK_N-point table, words with an all-zero range at rows 100-163
    and all -16 / -8 digit rows at 200-231, a non-identity chain."""
    pts = F.from_raw(BulletproofGens(WALK_N).G_raw(WALK_N), dev)
    rows = _scalar_rows(WALK_N, seed)
    rows[100:164] = 0
    if bits == 5:
        tbl, words = cc.table_w5(pts), ck.w5_words(rows, dev)
        words[200:232] = ALL_M16
    else:
        tbl, words = cc.table_w4(pts), ck.w4_words(rows, dev)
        words[200:232] = ALL_M8
    return pts, tbl, words, F.from_points(_points(1, seed + 1), dev)


def test_msm_win5_walks_match_plain_and_host_on_card(cuda_device):
    """msm_win5 at step counts around a thread row and pass 1's blocks,
    an all-zero word range (the chain back), all -16 rows, a split walk
    over both ends of the table, the whole table; chained on a
    non-identity point.  Every walk equals the plain version; the split,
    the -16 and the short walks equal the host MSM."""
    dev = cuda_device
    pts, tbl, words, chain = _walk_inputs(dev, 5, 130)
    host_chain = F.to_points(chain)[0]
    walks = [(v, 9, 300, v, 0) for v in WALK_STEPS] + [
        (64, 100, 100, 64, 0),  # all-zero words
        (32, 3000, 200, 32, 0),  # all -16 digits
        (40, WALK_N - 16, 190, 16, 5),  # split over both ends
        (WALK_N, 0, 0, WALK_N, 0),
    ]
    before = cc.LAUNCHES["msm_win5"]
    for walk in walks:
        got = cc.msm_win5(tbl, words, chain, *walk)
        want = cc.msm_win5_plain(tbl, words, chain, *walk)
        assert F.to_points(got) == F.to_points(want), walk
        if walk[0] <= 40:
            assert F.to_points(got)[0] == host_walk(pts, words, host_chain,
                                                    walk, 5), walk
    assert cc.LAUNCHES["msm_win5"] - before == len(walks)
    zero = cc.msm_win5(tbl, words, chain, 64, poff=100, woff=100)
    assert F.to_points(zero) == F.to_points(chain)


def test_msm_win_and_pair_walks_match_plain_and_host_on_card(cuda_device):
    """msm_win at the same step counts and edges over a w4 table (all -8
    rows), and msm_win_pair with two walks of unequal length (one of them
    split over both ends of the table, one a single step), two equal
    combined-round walks, and an empty walk beside a full one."""
    dev = cuda_device
    pts, tbl, words, chain = _walk_inputs(dev, 4, 140)
    host_chain = F.to_points(chain)[0]
    walks = [(v, 9, 300, v, 0) for v in WALK_STEPS] + [
        (64, 100, 100, 64, 0), (32, 3000, 200, 32, 0),
        (40, WALK_N - 16, 190, 16, 5), (WALK_N, 0, 0, WALK_N, 0),
    ]
    before = dict(cc.LAUNCHES)
    for walk in walks:
        got = cc.msm_win(tbl, words, chain, *walk)
        assert F.to_points(got) == F.to_points(
            cc.msm_win_plain(tbl, words, chain, *walk)), walk
        if walk[0] <= 40:
            assert F.to_points(got)[0] == host_walk(pts, words, host_chain,
                                                    walk, 4), walk
    chain2 = torch.cat([chain, F.from_points(_points(1, 141), dev)])
    pairs = [
        ((7681, 0, 0, 7681, 0), (40, WALK_N - 16, 190, 16, 5)),
        ((1, 5, 7, 1, 0), (513, 200, 200, 300, 4000)),
        ck.comb_walks(WALK_N // 4),
        ((0, 0, 0, 0, 0), (WALK_N, 0, 0, WALK_N, 0)),
    ]
    for pair in pairs:
        got = cc.msm_win_pair(tbl, words, chain2, pair)
        assert F.to_points(got) == F.to_points(
            cc.msm_win_pair_plain(tbl, words, chain2, pair)), pair
    got = F.to_points(cc.msm_win_pair(tbl, words, chain2, pairs[1]))
    for k in (0, 1):
        assert got[k] == host_walk(pts, words, F.to_points(chain2)[k],
                                   pairs[1][k], 4), k
    ran = {k: cc.LAUNCHES[k] - before[k] for k in before}
    assert {k: v for k, v in ran.items() if v} == {
        "msm_win": len(walks), "msm_win_pair": len(pairs) + 1}


def test_carry_chain_multiply_matches_fe_mul_on_card(cuda_device):
    """fe_mul_cc / fe_sq_cc against fe_mul / fe_sq (the test entry), word
    for word after the canonical store, one and 16 products deep, on
    every pair of the edges 0, 1, p - 1, p, p + 1, 2^255, 2^256 - 38,
    2^256 - 1 and 4096 random pairs; the edges also against Python ints."""
    P = (1 << 255) - 19
    edges = [0, 1, P - 1, P, P + 1, 1 << 255, (1 << 256) - 38, (1 << 256) - 1]
    pairs = [(x, y) for x in edges for y in edges]
    rng = np.random.RandomState(150)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(2 * 4096)]
    xs = [x for x, _ in pairs] + rand[:4096]
    ys = [y for _, y in pairs] + rand[4096:]
    a = torch.from_numpy(F.ints_to_words(xs).copy()).to(cuda_device)
    b = torch.from_numpy(F.ints_to_words(ys).copy()).to(cuda_device)
    for ref, new in (("fe_mul", "fe_mul_cc"), ("fe_sq", "fe_sq_cc")):
        for reps in (1, 16):
            assert torch.equal(cc.fe_mul_test(a, b, new, reps),
                               cc.fe_mul_test(a, b, ref, reps)), (new, reps)
        got = F.words_to_ints(cc.fe_mul_test(a, b, new)[: len(pairs)].cpu().numpy())
        sq = new == "fe_sq_cc"
        assert got == [x * (x if sq else y) % P for x, y in pairs], new


def test_gate_routes_on_card_match(cuda_device):
    """bench.py's gate circuit (VSMT-2 depth 8, padded 8192) on the card:
    the port's route and the host's ``NativeBackend`` give one proof,
    which verifies on the card."""
    import chip_smoke as cs
    import bulletproofs_r1cs_gadgets_tpu_torch as bp
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import (
        NativeBackend,
    )

    circuit = cs.gate_circuit(bp)
    gens = BulletproofGens(cs.GATE_N)
    backend = TorchBackend(cuda_device)
    proofs = []
    for be in (backend, NativeBackend()):
        comms, prover = cs.gate_prover(bp, circuit)
        proofs.append(prover.prove(gens, backend=be))
    assert proofs[0].to_bytes() == proofs[1].to_bytes()
    comp, tape = circuit[:2]
    cs.verify(bp, comp, tape, comms, proofs[0], gens, backend)


def _chain(cs, v, v2, links=32):
    _, _, o = cs.multiply(v + v2, v - v2)
    for _ in range(links):
        _, _, o = cs.multiply(o + Scalar(1), o + Scalar(2))


def _prover(seed=5, links=32):
    """links + 1 multipliers (33 padded to 64 by default), deterministic
    prover randomness."""
    prover = Prover(PedersenGens.default(), Transcript(b"cuda-chain"),
                    rng=np.random.RandomState(seed))
    com, v = prover.commit(Scalar(41), Scalar(97))
    com2, v2 = prover.commit(Scalar(5), Scalar(13))
    _chain(prover, v, v2, links)
    return (com, com2), prover


def _prove(backend):
    comms, prover = _prover()
    return comms, prover.prove(BulletproofGens(64), backend=backend)


def _verifier(comms, links=32):
    verifier = Verifier(Transcript(b"cuda-chain"))
    v, v2 = (verifier.commit(c) for c in comms)
    _chain(verifier, v, v2, links)
    return verifier


def _verify(comms, proof, backend):
    _verifier(comms).verify(proof, PedersenGens.default(),
                            BulletproofGens(64), backend=backend)


@pytest.mark.parametrize("max_side", [1024, 16])
def test_torch_backend_on_card_matches_host(cuda_device, max_side):
    comms, ref = _prove(None)
    backend = TorchBackend(cuda_device, min_device_n=1,
                           frozen_max_side=max_side)
    comms_d, got = _prove(backend)
    assert comms_d == comms
    assert got.to_bytes() == ref.to_bytes()
    _verify(comms, got, backend)
    raw = bytearray(got.to_bytes())
    raw[len(raw) - 64] ^= 1  # low byte of the IPP's `a` scalar
    with pytest.raises(VerificationError):
        _verify(comms, R1CSProof.from_bytes(bytes(raw)), backend)


def test_batch_on_card_matches_host(cuda_device):
    """prove_provers over three provers (64, 64 and 256 padded) on the
    card, walker threshold lowered: byte-identical to the host's
    sequential proofs, flotilla rounds launched, and one batch_verify
    accepts them and rejects a tampered member."""
    specs = [(5, 32), (6, 32), (7, 128)]
    gens = BulletproofGens(256)
    ref = [_prover(*s)[1].prove(gens) for s in specs]
    built = [_prover(*s) for s in specs]
    backend = TorchBackend(cuda_device, min_device_n=1, frozen_max_side=64,
                           walker_min_n=1)
    before = cc.LAUNCHES["msm_lane"]
    got = prove_provers([p for _, p in built], gens, backend=backend,
                        host_workers=1)
    assert [p.to_bytes() for p in got] == [p.to_bytes() for p in ref]
    assert cc.LAUNCHES["msm_lane"] - before == 3
    pc = PedersenGens.default()
    verifiers = [_verifier(c, s[1]) for (c, _), s in zip(built, specs)]
    batch_verify(verifiers, got, pc, gens, backend=backend)
    raw = bytearray(got[2].to_bytes())
    raw[len(raw) - 64] ^= 1
    bad = got[:2] + [R1CSProof.from_bytes(bytes(raw))]
    verifiers = [_verifier(c, s[1]) for (c, _), s in zip(built, specs)]
    with pytest.raises(VerificationError):
        batch_verify(verifiers, bad, pc, gens, backend=backend)


def test_combined_route_on_card_matches_host(cuda_device, monkeypatch):
    """129 multipliers (padded to 256) with the combined layout's
    threshold at 8: the round-1 transition, four combined rounds, the
    tail and the frozen rounds on the card, byte-identical to the host."""
    monkeypatch.setattr(tb, "COMB_MIN_N", 8)
    gens = BulletproofGens(256)
    comms, ref = _prover(9, 128)[0], _prover(9, 128)[1].prove(gens)
    backend = TorchBackend(cuda_device, min_device_n=1, frozen_max_side=4,
                           walker_min_n=1)
    before = dict(cc.LAUNCHES)
    got = _prover(9, 128)[1].prove(gens, backend=backend)
    assert got.to_bytes() == ref.to_bytes()
    ran = {k: cc.LAUNCHES[k] - before[k] for k in before}
    assert (ran["fold_w3h"], ran["table_w4"], ran["msm_win_pair"],
            ran["fold_w3h_comb"]) == (2, 4, 4, 4)
    _verifier(comms, 128).verify(got, PedersenGens.default(), gens,
                                 backend=backend)


# ------------------------------------------------ the multi-device layer
@pytest.fixture
def two_cards():
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        pytest.skip(f"needs two NVIDIA GPUs, this machine has {count}")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_msm_grid_local_matches_plain_on_card(cuda_device):
    """One two-chunk shard (4,096 points; words in every eighth row, past
    the valid span too) at valid 0, 1 and 2, one launch each; valid 0
    returns the accumulator."""
    dev = cuda_device
    n = 2 * ck.CHUNK
    pts = F.from_raw(BulletproofGens(n).G_raw(n), dev)
    rows = np.zeros((n, 4), np.uint64)
    rows[::8] = _scalar_rows(n // 8, 110)
    words = ck.w4_words(rows, dev)
    acc = F.from_points(_points(1, 111), dev)
    before = cc.LAUNCHES["msm_grid_local"]
    for valid in (0, 1, 2):
        got = cc.msm_grid_local(pts, words, acc, valid, ck.CHUNK)
        assert got.device == dev
        assert F.to_points(got) == F.to_points(
            cc.msm_grid_local_plain(pts, words, acc, valid, ck.CHUNK))
        if valid == 0:
            assert F.to_points(got) == F.to_points(acc)
    assert cc.LAUNCHES["msm_grid_local"] - before == 3


# ---- the windowed w4 MSM (csrc/win.cu) and the niels-table fold
# (csrc/fold_w3h.cu): sizes around a tile and past a card of blocks, edge
# rows, limits and breakpoints.  Equality by group element (chip_smoke's
# point_err): the kernels add in another order than the plain versions.
def _same_points(got, want) -> bool:
    import chip_smoke as cs

    return cs.point_err(F, got, want, (1 << 255) - 19) == 0


def _w4_inputs(dev, n: int, seed: int):
    """n generators and w4 words with 0, 1, L - 1 in rows 0-2, rows of all
    -8 digits every 7th row from 5 and zero rows every 11th from 6."""
    pts = F.from_raw(BulletproofGens(max(n, 1)).G_raw(max(n, 1)), dev)[:n]
    words = ck.w4_words(_scalar_rows(max(n, 3), seed)[:n], dev)
    words[5::7] = ALL_M8
    words[6::11] = 0
    return pts.contiguous(), words.contiguous()


def test_windowed_msm_w4_matches_plain_on_card(cuda_device):
    """msm_w4 at 0, 1, T - 1, T, T + 1 and 3T + 5 points (T the tile the
    library picks at small sizes), and at 8,209 and 16,387 points, where
    it picks its large tile (a full card of blocks), chained on a
    non-identity point; its first pass's scratch (bp_w4_partials) at edge
    sizes: whole windows of blocks, at least one block, one tile a block
    while they fit, and a bound once the card is full."""
    dev = cuda_device
    lib = build.load()
    build.check(lib.bp_set_device(dev.index), "set device")
    T = lib.bp_w4_tile(1, 1)
    acc = F.from_points(_points(1, 120), dev)
    before = cc.LAUNCHES["msm_w4"]
    sizes = (0, 1, T - 1, T, T + 1, 3 * T + 5, 8192 + 17, (1 << 14) + 3)
    assert len({lib.bp_w4_tile(n, 1) for n in sizes}) == 2, \
        [lib.bp_w4_tile(n, 1) for n in sizes]
    for n in sizes:
        pts, words = _w4_inputs(dev, n, 121 + n % 1000)
        got = cc.msm_w4(pts, words, acc)
        assert _same_points(got, cc.msm_w4_plain(pts, words, acc)), n
    assert cc.LAUNCHES["msm_w4"] - before == len(sizes)
    assert F.to_points(cc.msm_w4(*_w4_inputs(dev, 0, 1), acc)) == \
        F.to_points(acc)
    for walks in (1, 2):
        per = 64 * walks
        blocks = [lib.bp_w4_partials(v, walks) for v in
                  (0, 1, T, T + 1, 1 << 14, 1 << 20, 1 << 22)]
        assert all(b % per == 0 for b in blocks), blocks
        nb = [b // per for b in blocks]
        assert nb[:4] == [1, 1, 1, 2], nb
        assert nb == sorted(nb) and nb[-1] <= nb[-2] * 1.01 + 1, nb
        assert nb[4] <= -(-(1 << 14) // T), nb


def test_windowed_msm_w4_pair_matches_plain_on_card(cuda_device):
    """msm_w4_pair with lo_limit 0, with hi_limit 0, with the grid round's
    unequal limits (lo_limit = vR, R's zero tail) and both full, each
    segment chained on its own point."""
    dev = cuda_device
    T = build.load().bp_w4_tile(1, 2)
    half = 3 * T + 5
    pts, words = _w4_inputs(dev, 2 * half, 130)
    acc2 = F.from_points(_points(2, 131), dev)
    before = cc.LAUNCHES["msm_w4_pair"]
    limits = ((0, half), (half, 0), (T + 1, half), (half, half), (0, 0))
    for lo, hi in limits:
        got = cc.msm_w4_pair(pts, words, acc2, half, lo, hi)
        assert _same_points(
            got, cc.msm_w4_pair_plain(pts, words, acc2, half, lo, hi)), (lo, hi)
    assert cc.LAUNCHES["msm_w4_pair"] - before == len(limits)


def test_windowed_msm_grid_local_matches_plain_on_card(cuda_device):
    """msm_grid_local over a 32-chunk shard (65,536 points; words past
    every valid span nonzero) at 0, 7 and 32 live chunks."""
    dev = cuda_device
    n = 32 * ck.CHUNK
    pts, words = _w4_inputs(dev, n, 140)
    acc = F.from_points(_points(1, 141), dev)
    for valid in (0, 7, 32):
        got = cc.msm_grid_local(pts, words, acc, valid, ck.CHUNK)
        assert _same_points(
            got, cc.msm_grid_local_plain(pts, words, acc, valid, ck.CHUNK)), valid


@pytest.mark.parametrize("v", [1, 127, 129])
def test_niels_fold_matches_plain_on_card(cuda_device, v):
    """fold_w3h and fold_w3h_comb at v = 1, 127 and 129 outputs a side,
    random half-gcd pairs and the edge pairs (0, 1) / (1, -1), the
    breakpoint at 0, at v and inside a block (not a multiple of it)."""
    dev = cuda_device
    rng = np.random.RandomState(150 + v)
    pts = F.from_raw(BulletproofGens(4 * v).G_raw(4 * v), dev)
    rand = [ck.half_gcd_split(int.from_bytes(rng.bytes(32), "little") % L, L)
            for _ in range(2)]
    edge = [(0, 1), (1, -1)]
    before = dict(cc.LAUNCHES)
    for bp_ in sorted({0, v, v // 2 + 1}):
        for pairs in (rand, edge):
            words = ck.w3h_fold_words([pairs], dev)
            got = cc.fold_w3h(pts[: 2 * v], words, bp_)
            assert _same_points(got, cc.fold_w3h_plain(pts[: 2 * v], words, bp_)), \
                (bp_, pairs)
        words = ck.w3h_fold_words([rand, edge], dev)
        got = cc.fold_w3h_comb(pts, words, bp_)
        assert _same_points(got, cc.fold_w3h_comb_plain(pts, words, bp_)), bp_
    runs = len({0, v, v // 2 + 1})
    assert cc.LAUNCHES["fold_w3h"] - before["fold_w3h"] == 2 * runs
    assert cc.LAUNCHES["fold_w3h_comb"] - before["fold_w3h_comb"] == runs


@pytest.mark.parametrize("v", [16, 24, 64, 128])
def test_windowed_msm_lane_matches_plain_on_card(cuda_device, v):
    """msm_lane over v segments of 2,048 points (the batch of 8's
    flotilla; the reference's batch of 12; 64 and 128, the most a batch of
    up to 64 provers gives): rows 0, 1, L - 1, all -8
    digits and zero rows, an all-zero segment, and the last segment
    identity-padded past two thirds with zero words as ck.flotilla_pack
    pads; then 3 segments of T + 1 points (T the tile the library picks),
    each ending one point into a tile."""
    dev = cuda_device
    lib = build.load()
    build.check(lib.bp_set_device(dev.index), "set device")
    seg = 2048
    pts, words = _w4_inputs(dev, v * seg, 170 + v)
    words[seg : 2 * seg] = 0
    tail = (v - 1) * seg + 2 * seg // 3
    pts[tail:] = F.identity_points(v * seg - tail, dev)
    words[tail:] = 0
    before = cc.LAUNCHES["msm_lane"]
    got = cc.msm_lane(pts, words, v)
    assert _same_points(got, cc.msm_lane_plain(pts, words, v))
    assert F.to_points(got[1:2])[0].is_identity()
    T = lib.bp_w4_tile(1, 3)
    p3, w3 = _w4_inputs(dev, 3 * (T + 1), 171)
    assert _same_points(cc.msm_lane(p3, w3, 3), cc.msm_lane_plain(p3, w3, 3))
    assert cc.LAUNCHES["msm_lane"] - before == 2


@pytest.mark.parametrize("v", [2048, 1 << 17])
def test_constant_fold_designs_match_plain_on_card(cuda_device, v):
    """fold_c at the port's 2,048 outputs (padded n = 4096's round 1) and
    at 2^17 (round 1 of the reference's winmsm-off and w3h-off routes),
    by the library's choice (group, then thread) and under each design:
    random constants split inside a warp, the edge constants (0, 1) split
    at 0, and (L - 1, all -8 digits) split at v; each in place; then
    fold_c_comb at v / 2 a side under each design, each side word for word
    fold_c's under the same design."""
    dev = cuda_device
    rng = np.random.RandomState(180)

    def rand():
        return Scalar(int.from_bytes(rng.bytes(32), "little") % L)

    pts = F.from_raw(BulletproofGens(2 * v).G_raw(2 * v), dev)
    edge = ck.c_fold_words([(Scalar(L - 1), Scalar(1))], dev)
    edge[0, 1] = ALL_M8
    cases = ((ck.c_fold_words([(rand(), rand())], dev), v // 2 + 1),
             (ck.c_fold_words([(Scalar(0), Scalar(1))], dev), 0), (edge, v))
    assert cc.fold_c_design(dev, v) == ("group" if v == 2048 else "thread")
    before = cc.LAUNCHES["fold_c"]
    for words, bp_ in cases:
        plain = cc.fold_c_plain(pts, words, bp_)
        for d in (None, *cc.FOLD_C_DESIGNS):
            got = cc.fold_c(pts, words, bp_, design=d)
            assert _same_points(got, plain), (bp_, d)
            own = pts.clone()
            assert torch.equal(cc.fold_c(own, words, bp_, out=own[:v], design=d), got)
    assert cc.LAUNCHES["fold_c"] - before == 2 * 3 * len(cases)
    m = v // 2
    words = ck.c_fold_words([(rand(), rand()), (Scalar(0), Scalar(1))], dev)
    plain = cc.fold_c_comb_plain(pts, words, m // 3)
    for d in cc.FOLD_C_DESIGNS:
        got = cc.fold_c_comb(pts, words, m // 3, design=d)
        assert _same_points(got, plain), d
        for s_ in (0, 1):
            one = cc.fold_c(pts[2 * m * s_ : 2 * m * (s_ + 1)],
                            words[s_ : s_ + 1].contiguous(), m // 3, design=d)
            assert torch.equal(got[m * s_ : m * (s_ + 1)], one), (d, s_)


@pytest.mark.parametrize("n", [1000, 1024, 2048])
def test_cooperative_fold_bits_matches_plain_on_card(cuda_device, n):
    """fold_bits at the main path's 1,024 lanes, phase 2's 2,048 and at
    1,000 (not a multiple of a block's eight outputs): ones on the left
    as the IPP folds use, random right scalars, and in front both scalars
    zero, wl = 0, wl = L - 1, every nibble 8 and bits 253..255 set (not
    read)."""
    dev = cuda_device
    g = BulletproofGens(n)
    left, right = F.from_raw(g.G_raw(n), dev), F.from_raw(g.H_raw(n), dev)
    wl = ck.bit_words(scvec.from_ints([1] * n))
    wr = ck.bit_words(_scalar_rows(n, 160 + n % 13))
    wl[:2] = 0
    wr[0] = 0
    wl[2] = ck.bit_words(scvec.from_ints([L - 1]))[0]
    wl[3] = wr[3] = ALL_M8
    wl[4, 7] |= -0x20000000
    wr[4, 7] |= -0x20000000
    wl, wr = torch.from_numpy(wl).to(dev), torch.from_numpy(wr).to(dev)
    before = cc.LAUNCHES["fold_bits"]
    got = cc.fold_bits(left, right, wl, wr)
    assert _same_points(got, cc.fold_bits_plain(left, right, wl, wr))
    assert F.to_points(got[:1])[0].is_identity()
    assert cc.LAUNCHES["fold_bits"] - before == 1


def test_two_role_tables_match_plain_on_card(cuda_device):
    """table_w4 and table_w5 at 2^13 + 5 points (a ragged last block of
    32), byte for byte; table_w4 into `out` (a larger table's first rows,
    the rest untouched) and as table_w5's first half."""
    dev = cuda_device
    n = (1 << 13) + 5
    pts = F.from_raw(BulletproofGens(n).G_raw(n), dev)
    before = dict(cc.LAUNCHES)
    tbl = cc.table_w4(pts)
    assert torch.equal(tbl, cc.table_w4_plain(pts))
    spare = torch.full((n + 7, cc.TBL4, 4, 8), -1, dtype=torch.int32, device=dev)
    got = cc.table_w4(pts, out=spare)
    assert got.data_ptr() == spare.data_ptr()
    assert torch.equal(got, tbl) and bool((spare[n:] == -1).all())
    t5 = cc.table_w5(pts)
    assert torch.equal(t5, cc.table_w5_plain(pts))
    assert torch.equal(tbl, t5[:, : cc.TBL4])
    assert cc.LAUNCHES["table_w4"] - before["table_w4"] == 2
    assert cc.LAUNCHES["table_w5"] - before["table_w5"] == 1


def test_oracle_kernels_match_plain_on_card(cuda_device):
    """The device-oracle path's eight kernels at ragged sizes (n not a
    multiple of 128 or 2048), each against its plain version on the same
    CUDA tensors: word for word, but the redesigned smul_lanes,
    msm_block_totals, msm_chunk_acc and fold_grid by group element; one
    launch each."""
    dev = cuda_device
    n = 2048 + 45
    pts = F.from_raw(BulletproofGens(2 * n).G_raw(2 * n), dev)
    a, b = pts[:n], pts[n:]
    rows = _scalar_rows(n, 120)
    rows[5:9] = 0
    words = torch.from_numpy(ck.bit_words(rows)).to(dev)
    acc = F.from_points(_points(1, 121), dev)
    before = dict(cc.LAUNCHES)
    assert torch.equal(cc.padd(a, b), cc.padd_plain(a, b))
    assert torch.equal(cc.pdbl(a), cc.pdbl_plain(a))
    m = 300
    assert _same_points(cc.smul_lanes(a[:m], words[:m]),
                        cc.smul_lanes_plain(a[:m], words[:m]))
    assert _same_points(cc.msm_block_totals(a, words),
                        cc.msm_block_totals_plain(a, words))
    assert _same_points(cc.msm_chunk_acc(a, words, acc),
                        cc.msm_chunk_acc_plain(a, words, acc))
    v = 200
    wl = ck.w2_words(_scalar_rows(v, 122), dev)
    wr = ck.const_grid_words(Scalar(L - 1), dev)
    assert _same_points(cc.fold_grid(pts, wl, wr, v),
                        cc.fold_grid_plain(pts, wl, wr, v))
    x = F.ints_to_words([0, 1, L - 1, (1 << 256) - 1] * 64)
    fa = torch.from_numpy(x.copy()).to(dev)
    fb = fa.flip(0).contiguous()
    assert torch.equal(cc.mul_fq(fa, fb), cc.mul_fq_plain(fa, fb))
    assert torch.equal(cc.mul_fp(fa, fb), cc.mul_fp_plain(fa, fb))
    ran = {k: cc.LAUNCHES[k] - before[k] for k in before}
    assert {k: v for k, v in ran.items() if v} == {
        "padd": 1, "pdbl": 1, "smul_lanes": 1, "msm_block_totals": 1,
        "msm_chunk_acc": 1, "fold_grid": 1, "mul_fp": 1, "mul_fq": 1,
    }


@pytest.mark.parametrize("n", [1, 129, (1 << 18) + 77])
def test_pointwise_ops_match_plain_on_card(cuda_device, n):
    """padd / pdbl at 1, 129 (a ragged second tile) and 2^18 + 77 points
    (past a card of resident blocks: the grid strides), on coordinates in
    [p, 2^256) with the identity and a point plus its negation among the
    rows: word for word against the plain versions, which give the
    canonical inputs' words; the first rows against the host group law."""
    dev = cuda_device
    a, b, a2, b2 = pointwise_inputs(n, 860 + n % 1000)
    a, b, a2, b2 = (t.to(dev) for t in (a, b, a2, b2))
    before = dict(cc.LAUNCHES)
    add, dbl = cc.padd(a2, b2), cc.pdbl(a2)
    assert torch.equal(add, cc.padd_plain(a2, b2))
    assert torch.equal(dbl, cc.pdbl_plain(a2))
    assert torch.equal(add, cc.padd(a, b)) and torch.equal(dbl, cc.pdbl(a))
    k = min(n, 8)
    ha, hb = F.to_points(a[:k]), F.to_points(b[:k])
    assert F.to_points(add[:k]) == [x + y for x, y in zip(ha, hb)]
    assert F.to_points(dbl[:k]) == [x.double() for x in ha]
    if n > 2:
        assert F.to_points(add[2:3])[0].is_identity()
    ran = {k: cc.LAUNCHES[k] - before[k] for k in before}
    assert {k: v for k, v in ran.items() if v} == {"padd": 2, "pdbl": 2}


@pytest.mark.parametrize("n", [0, 1, 33, 1 << 13, 1 << 16])
def test_smul_lanes_designs_match_plain_on_card(cuda_device, n):
    """smul_lanes at 0, 1, 33, 2^13 and 2^16 lanes (the device-oracle
    path's proving_step), by the library's choice and under each design,
    over bit words with 0, 1, L - 1 and 2^253 - 1 in front, bits 253..255
    set (not read) and zero rows: by group element against the plain
    version (the bit ladder), and the first lanes against the host scalar
    multiply."""
    dev = cuda_device
    pts, words = _bit_inputs(dev, n, 230 + n % 1000)
    if n > 3:
        words[3] = torch.from_numpy(
            np.frombuffer(((1 << 253) - 1).to_bytes(32, "little"), "<i4").copy())
    plain = cc.smul_lanes_plain(pts, words)
    before = cc.LAUNCHES["smul_lanes"]
    for d in (None, *cc.SMUL_LANES_DESIGNS):
        got = cc.smul_lanes(pts, words, design=d)
        assert got.shape == (n, 4, 8)
        assert _same_points(got, plain), (n, d)
    assert cc.LAUNCHES["smul_lanes"] - before == 3
    if n in (1, 33, 1 << 16):
        want = "thread" if n == 1 << 16 else "group"
        assert cc.smul_lanes_design(dev, n) == want
    k = min(n, 8)
    host = [p.scalar_mul(Scalar(_bits_value(r) % L))
            for p, r in zip(F.to_points(pts[:k]), words[:k].tolist())]
    assert F.to_points(cc.smul_lanes(pts[:k].contiguous(),
                                     words[:k].contiguous())) == host


def _bits_value(row) -> int:
    """Bits 252..0 of a bit word row (the bit-word MSMs read no more)."""
    v = sum((int(w) & 0xFFFFFFFF) << (32 * j) for j, w in enumerate(row))
    return v % (1 << 253)


def _bit_inputs(dev, n: int, seed: int):
    """n generators and bit words: 0, 1, L - 1 in rows 0-2, bits 253..255
    set (not read) every 13th row from 4 and zero rows every 11th from 6."""
    pts = F.from_raw(BulletproofGens(max(n, 1)).G_raw(max(n, 1)), dev)[:n]
    words = ck.bit_words(_scalar_rows(max(n, 3), seed)[:n])
    words[4::13, 7] |= -0x20000000
    words[6::11] = 0
    return pts.contiguous(), torch.from_numpy(words).to(dev)


def test_bit_word_msms_match_plain_on_card(cuda_device):
    """msm_chunk_acc (the windowed w4 MSM over bit words, recoded at the
    tiles' load) at 0, 1, T + 1 and 3T + 5 points (T
    the library's small tile), 8,209 and 2^14 (the path's chunk: the
    large tile), chained on a non-identity point; msm_block_totals at 100,
    2,048 and 2^16 + 1,000 points (one short block, one full block, 33
    blocks with a ragged last one and an all-zero block): each by group
    element against its plain version, and on a subset against the host
    MSM."""
    dev = cuda_device
    T = build.load().bp_w4_tile(1, 1)
    acc = F.from_points(_points(1, 190), dev)
    before = dict(cc.LAUNCHES)
    sizes = (0, 1, T + 1, 3 * T + 5, 8192 + 17, 1 << 14)
    for n in sizes:
        pts, words = _bit_inputs(dev, n, 191 + n % 1000)
        got = cc.msm_chunk_acc(pts, words, acc)
        assert _same_points(got, cc.msm_chunk_acc_plain(pts, words, acc)), n
    pts, words = _bit_inputs(dev, 40, 192)
    host = multiscalar_mul(
        [Scalar(_bits_value(r) % L) for r in words.tolist()]
        + [Scalar(1)], F.to_points(pts) + F.to_points(acc))
    assert F.to_points(cc.msm_chunk_acc(pts, words, acc))[0] == host
    totals = (100, 2048, (1 << 16) + 1000)
    for n in totals:
        pts, words = _bit_inputs(dev, n, 193 + n % 1000)
        if n > 4096:
            words[2048:4096] = 0
        got = cc.msm_block_totals(pts, words)
        assert got.shape == (-(-n // 2048), 4, 8)
        assert _same_points(got, cc.msm_block_totals_plain(pts, words)), n
        if n > 4096:
            assert F.to_points(got[1:2])[0].is_identity()
    ran = {k: cc.LAUNCHES[k] - before[k] for k in before}
    assert ran["msm_chunk_acc"] == len(sizes) + 1
    assert ran["msm_block_totals"] == len(totals)


@pytest.mark.parametrize("blocks", [64, 128])
def test_block_totals_over_many_blocks_on_card(cuda_device, blocks):
    """msm_block_totals over 64 and 128 blocks of 2,048 points (128: a
    2^18-point generator set through MsmEngine.msm), the last block
    ragged by 7 points: by group element against its plain version, and
    its last two totals against the host MSM."""
    dev = cuda_device
    n = blocks * 2048 - 7
    pts, words = _bit_inputs(dev, n, 200 + blocks)
    got = cc.msm_block_totals(pts, words)
    assert _same_points(got, cc.msm_block_totals_plain(pts, words))
    lo = (blocks - 2) * 2048
    rows = words[lo:].tolist()
    host = F.to_points(pts[lo:])
    sc = [Scalar(_bits_value(r) % L) for r in rows]
    assert F.to_points(got[-2:]) == [multiscalar_mul(sc[:2048], host[:2048]),
                                     multiscalar_mul(sc[2048:], host[2048:])]


@pytest.mark.parametrize("v", [1, 2048 + 3, 1 << 13, 1 << 17])
def test_fold_grid_designs_match_plain_on_card(cuda_device, v):
    """fold_grid at v = 1, 2,051 (a ragged last warp), 2^13 and 2^17
    (the device-oracle path's round 1) outputs, by the library's choice
    (group up to half a card of groups, thread past it: group at 1 and
    2,051, thread at 2^17) and under each
    design: per-lane words with 0, 1, L - 1 and all -2 digits (window 64's
    borrow) in front, and the constant rows (u^-1, u); by group element
    against the plain version, and the first lanes against the host
    group law."""
    dev = cuda_device
    rng = np.random.RandomState(210)
    pts = F.from_raw(BulletproofGens(2 * v + 1).G_raw(2 * v + 1), dev)
    wl = ck.w2_words(_scalar_rows(max(v, 3), 211)[:v], dev)
    wr = ck.w2_words(_scalar_rows(max(v, 3), 212)[::-1][:v].copy(), dev)
    if v > 3:
        wl[3] = wr[3] = -0x55555556  # 0xaaaaaaaa: every w2 digit -2
    u = Scalar(int.from_bytes(rng.bytes(32), "little") % L)
    const = (ck.const_grid_words(u.invert(), dev), ck.const_grid_words(u, dev))
    design = cc.fold_grid_design(dev, v)
    if v <= 2048 + 3 or v == 1 << 17:
        assert design == ("thread" if v == 1 << 17 else "group"), design
    before = cc.LAUNCHES["fold_grid"]
    for a, b in ((wl, wr), const):
        plain = cc.fold_grid_plain(pts, a, b, v)
        for d in (None, *cc.FOLD_GRID_DESIGNS):
            got = cc.fold_grid(pts, a, b, v, design=d)
            assert _same_points(got, plain), (v, d)
    assert cc.LAUNCHES["fold_grid"] - before == 2 * 3
    got = F.to_points(cc.fold_grid(pts, *const, v)[:3])
    host = F.to_points(pts[:3]) + F.to_points(pts[v : v + 3])
    assert got == [host[i].scalar_mul(u.invert()) + host[3 + i].scalar_mul(u)
                   for i in range(min(3, v))]


def test_device_backend_on_card_matches_host(cuda_device):
    """A proof through DeviceBackend("cuda", min_device_n=1): the host
    engine's bytes, verified through it, a tampered copy rejected."""
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.backend import DeviceBackend

    comms, ref = _prove(None)
    backend = DeviceBackend(cuda_device, min_device_n=1)
    before = dict(cc.LAUNCHES)
    comms_d, got = _prove(backend)
    assert comms_d == comms
    assert got.to_bytes() == ref.to_bytes()
    _verify(comms, got, backend)
    raw = bytearray(got.to_bytes())
    raw[len(raw) - 64] ^= 1
    with pytest.raises(VerificationError):
        _verify(comms, R1CSProof.from_bytes(bytes(raw)), backend)
    for name in ("msm_chunk_acc", "fold_grid"):
        assert cc.LAUNCHES[name] > before[name], name


def test_sharded_walk_over_two_cards(two_cards):
    """Two shards, one chunk each, on cuda:0 and cuda:1: each shard's
    points on its card, the totals equal to one msm_w4 on cuda:0 over the
    valid span (all of it, then the first chunk)."""
    dev0, _ = two_cards
    sharded = ShardedWalkMsm(list(two_cards), local_chunks=1)
    assert "shards on" not in repr(sharded)  # two distinct cards
    n = 2 * ck.CHUNK
    pts = F.from_raw(BulletproofGens(n).G_raw(n))
    words = ck.w4_words(_scalar_rows(n, 120), "cpu")
    shards = sharded.place(pts)
    assert [s.device for s in shards] == list(two_cards)
    before = cc.LAUNCHES["msm_grid_local"]
    for valid in (2, 1):
        m = valid * ck.CHUNK
        want = cc.msm_w4(pts[:m].to(dev0), words[:m].to(dev0),
                         F.identity_points(1, dev0))
        assert sharded.msm(shards, words, valid) == F.to_points(want)[0]
    assert cc.LAUNCHES["msm_grid_local"] - before == 4


def test_backend_on_second_card_from_any_thread(two_cards):
    """A TorchBackend on cuda:1 with cuda:0 current: a proof from the main
    thread, a batch through prove_provers (its IPP rounds launch from a
    thread pool) and a placed batch over both cards, byte-identical to
    cuda:0's; the main thread's device stays cuda:0."""
    dev0, dev1 = two_cards
    torch.cuda.set_device(dev0)
    gens = BulletproofGens(64)

    def backend(device):
        return TorchBackend(device, min_device_n=1, frozen_max_side=16)

    seeds = (5, 6, 7)
    want = [_prover(s)[1].prove(gens, backend=backend(dev0)) for s in seeds]
    be1 = backend(dev1)
    before = dict(cc.LAUNCHES)
    comms, alone = _prover(seeds[0])
    alone = alone.prove(gens, backend=be1)
    assert alone.to_bytes() == want[0].to_bytes()
    assert torch.cuda.current_device() == 0
    batch = prove_provers([_prover(s)[1] for s in seeds], gens, backend=be1)
    assert [p.to_bytes() for p in batch] == [p.to_bytes() for p in want]
    assert sum(cc.LAUNCHES[k] - before[k] for k in before) > 0
    placed = prove_provers_devices([_prover(s)[1] for s in seeds], gens,
                                   devices=list(two_cards),
                                   backend_factory=backend)
    assert [p.to_bytes() for p in placed] == [p.to_bytes() for p in want]
    assert torch.cuda.current_device() == 0
    _verify(comms, alone, be1)


def test_verify_rows_edges_on_card(cuda_device):
    """The verifier-row kernels against the host's arrays on edge shapes:
    ``sc_powers`` around its run, ``tape_flatten`` with a wire of more
    than ``TS_REDUCE`` terms and empty wires, ``tape_sums`` over several
    blocks and with no constant terms."""
    import test_torch_verify_rows as tvr

    tvr.edge_checks(cuda_device)


@pytest.mark.parametrize("circuit", ["vsmt2-d4", "vsmt4-d128"])
def test_verify_rows_match_plain_on_card(cuda_device, circuit, monkeypatch):
    """The verifier's G/H rows on the card at VSMT-2 depth 4 (padded 4,096)
    and VSMT-4 depth 128 (padded 2^17, a benchmark cell's): each kernel's
    output equals its plain version on the same CUDA tensors, word for
    word, and the words equal ``w5_words`` of the host job's g and h; a
    verification through them accepts, counts 2N ``device_rows`` on its
    ``msm_gens`` span, and rejects a flipped byte and a wrong root."""
    import chip_smoke as cs
    import bulletproofs_r1cs_gadgets_tpu_torch as bp
    import test_torch_verify_rows as tvr
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import verify_rows as vr
    from bulletproofs_r1cs_gadgets_tpu_torch.utils import metrics

    dev = cuda_device
    backend = TorchBackend(dev)
    case = (cs.vsmt2_case(bp, cs.SMALL_DEPTH, backend)
            if circuit == "vsmt2-d4" else cs.vsmt4_case(bp, 128, backend))
    host, job, rows, _ = tvr.jobs(case, backend, monkeypatch)
    t, n, N = rows.tape, rows.n, rows.N
    tables = [vr.power_tables(rows.z, 1, t.m, dev),
              vr.power_tables(rows.y_inv, 0, N, dev),
              vr.s_tables(*rows._s, dev)]
    zp, yinv, s = (cc.sc_powers(hi, lo, m)
                   for (hi, lo), m in zip(tables, (t.m, N, N)))
    for (hi, lo), m, got in zip(tables, (t.m, N, N), (zp, yinv, s)):
        assert torch.equal(got, cc.sc_powers_plain(hi, lo, m))
    assert torch.equal(yinv, rows.yinv)
    assert torch.equal(rows.wires,
                       cc.tape_flatten_plain(t.off, t.cidx, t.coeff, zp))
    sums = cc.tape_sums(t.ccidx, t.ccoeff, zp, rows.wires, yinv, n)
    assert torch.equal(sums, cc.tape_sums_plain(t.ccidx, t.ccoeff, zp,
                                                rows.wires, yinv, n))
    consts = vr.host_words(rows._consts).reshape(1, 8, 8)
    words = rows.words()
    assert torch.equal(words, cc.gh_rows_plain(
        [(rows.wires, yinv, s, n, rows.n1)], consts))
    assert torch.equal(words, torch.cat([ck.w5_words(host.g, dev),
                                         ck.w5_words(host.h, dev)]))
    metrics.take()
    metrics.enable()
    try:
        assert cs.verdict(bp, case.verifier(), case.proof, case.gens, backend)
        spans = metrics.take()
    finally:
        metrics.disable()
        metrics.take()
    assert tvr._device_rows(spans) == [2 * N]
    assert not cs.verdict(bp, case.verifier(), cs.tampered(bp, case.proof),
                          case.gens, backend)
    assert not cs.verdict(bp, case.wrong(), case.proof, case.gens, backend)


@pytest.mark.parametrize("B", [2, 8])
def test_batch_rows_match_plain_on_card(cuda_device, B):
    """A batch's rows on the card (``gh_rows`` over B row sets of distinct
    transcripts of the depth-4 VSMT-2 proof, weighted by their rhos) equal
    the summed kernel's plain version on the same CUDA tensors and the
    words of the host's rho-weighted sum of the jobs' g and h; a
    ``batch_verify`` of B copies of the proof through the card's rows
    accepts with 2N ``device_rows`` and names a flipped byte."""
    import chip_smoke as cs
    import bulletproofs_r1cs_gadgets_tpu_torch as bp
    import test_torch_verify_rows as tvr
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import verify_rows as vr
    from bulletproofs_r1cs_gadgets_tpu_torch.utils import metrics

    dev = cuda_device
    backend = TorchBackend(dev)
    case = cs.vsmt2_case(bp, cs.SMALL_DEPTH, backend)
    rows, rhos, g, h = tvr.batch_rows(case, backend, B)
    words = vr.VerifyRows.summed(rows, rhos, None, None).words()
    assert torch.equal(words, tvr.summed_plain(rows, rhos))
    assert torch.equal(words, torch.cat([ck.w5_words(g, dev),
                                         ck.w5_words(h, dev)]))
    proofs = [case.proof] * B
    metrics.take()
    metrics.enable()
    try:
        batch_verify([case.verifier() for _ in proofs], proofs,
                     PedersenGens.default(), case.gens, backend=backend)
        spans = metrics.take()
        proofs[B - 1] = cs.tampered(bp, case.proof)
        with pytest.raises(VerificationError, match=rf"\[{B - 1}\]"):
            batch_verify([case.verifier() for _ in proofs], proofs,
                         PedersenGens.default(), case.gens, backend=backend)
    finally:
        metrics.disable()
        metrics.take()
    assert tvr._device_rows(spans) == [2 * rows[0].N]


def test_mixed_size_batch_on_card(cuda_device):
    """A batch of two padded sizes on the card: VSMT-2 proofs at depth 4
    (4,096) and depth 8 (8,192).  One ``gh_rows`` sums the three row
    sets, the smaller ones adding nothing from their own size on: equal
    to the plain version on the same CUDA tensors and to the words of the
    host's rho-weighted sum of the jobs' rows padded with zeros; a
    ``batch_verify`` of the three accepts with 2 x 8,192 ``device_rows``
    on its one ``msm_gens`` and names a flipped byte in a smaller proof."""
    import chip_smoke as cs
    import bulletproofs_r1cs_gadgets_tpu_torch as bp
    import numpy as np
    import test_torch_verify_rows as tvr
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import verify_rows as vr
    from bulletproofs_r1cs_gadgets_tpu_torch.utils import metrics

    dev = cuda_device
    backend = TorchBackend(dev)
    small = cs.vsmt2_case(bp, cs.SMALL_DEPTH, backend)
    big = cs.vsmt2_case(bp, 8, backend)
    rng = np.random.RandomState(8)
    rhos = [bp.Scalar.one()] + [
        bp.Scalar.from_bytes_mod_order_wide(rng.bytes(64)) for _ in range(2)]
    rows, g, h = tvr.summed_rows(
        [(small, small.proof), (big, big.proof),
         (small, tvr.variant(small.proof, 1))], backend, rhos)
    assert [r.N for r in rows] == [4096, 8192, 4096]
    words = vr.VerifyRows.summed(rows, rhos, None, None).words()
    assert words.shape == (2 * 8192, 16)
    assert torch.equal(words, tvr.summed_plain(rows, rhos))
    assert torch.equal(words, torch.cat([ck.w5_words(g, dev),
                                         ck.w5_words(h, dev)]))
    cases = [small, big, small]
    proofs = [c.proof for c in cases]
    metrics.take()
    metrics.enable()
    try:
        batch_verify([c.verifier() for c in cases], proofs,
                     PedersenGens.default(), big.gens, backend=backend)
        spans = metrics.take()
        proofs[2] = cs.tampered(bp, small.proof)
        with pytest.raises(VerificationError, match=r"\[2\]"):
            batch_verify([c.verifier() for c in cases], proofs,
                         PedersenGens.default(), big.gens, backend=backend)
    finally:
        metrics.disable()
        metrics.take()
    assert tvr._device_rows(spans) == [2 * 8192]
