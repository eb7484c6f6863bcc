#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths, a VSMT-2 depth-253 membership proof
(143,704 multipliers padded to 2^18) proved alone and a batch of eight
proved through ``prove_provers`` and verified by one ``batch_verify``,
through ``TorchBackend("cuda")``, and checks every kernel on the way.
Phases, each printing one line with its wall time (any failure exits
non-zero and prints no result):

0. device: nvidia-smi name and power limit, torch / CUDA versions; no
   CUDA device is a failure (this never runs on the CPU).
1. build the kernels from ``bulletproofs_r1cs_gadgets_tpu_torch/csrc``
   (one ``nvcc -c`` per source, all in parallel, then one link).
2. each kernel against its plain torch version on the card at main-path
   shapes (msm_w4 over 2^14 points, msm_w4_pair over a 4096-point frozen
   pack with limits 0 / partial / full, fold_bits over 2048 lanes,
   table_w5 over the 2^18 shared generators, msm_win5 over that table
   at the main path's walks (phase 1's 143,704 points, IPP round 1's
   2^17 at offset 2^17 and its short a_R walk, the verifier's 2^18)
   plus a poff / split / poff2 walk, msm_lane over 16 segments of 2048
   points with an all-zero one), and on a subset against the host MSM.
   Tolerance: exact (equal points, equal table words).
3. a VSMT-2 depth-4 proof through the port, byte-identical to the host
   path with the same prover randomness and verified by the port's and
   the host verifier; then a batch of three depth-4 provers through
   ``prove_provers``, each proof byte-identical to the same prover proved
   alone through the port (flotilla rounds run).
4. the depth-253 proof: one cold prove, two warm proves, the port's
   verifier; a tampered proof and a wrong root must raise
   VerificationError.  Launch counts are taken over this phase.
5. the depth-253 batch of eight (different leaves, deterministic prover
   randomness) through ``prove_provers`` as a user calls it (the default
   host pool: each prover's rng is private, so the pool cannot change
   the bytes): wall time, proofs/s and peak device memory; one
   ``batch_verify`` of the eight; proof 0 equals, byte for byte, the
   same prover re-proved alone; a batch holding one tampered proof must
   raise VerificationError.  Launch counts are taken over the batch's
   prove and verify.

The third line from the end is the card's nvidia-smi name and power
limit, the line before the last holds the per-kernel JSON record
(``launches`` summed over phases 4 and 5), and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "bulletproofs_r1cs_gadgets_tpu_torch"
_W4 = f"{PKG}/csrc/msm_fold.cu"
_W5 = f"{PKG}/csrc/win5.cu"
SOURCES = {
    "msm_w4": _W4, "msm_w4_pair": _W4, "fold_bits": _W4, "msm_lane": _W4,
    "table_w5": _W5, "msm_win5": _W5,
}
_PC = "bulletproofs_r1cs_gadgets_tpu/ops/pallas_curve.py"
REPLACES = {
    "msm_w4": f"{_PC}:369",
    "msm_w4_pair": f"{_PC}:768",
    "fold_bits": f"{_PC}:1566",
    "table_w5": f"{_PC}:1233",
    "msm_win5": f"{_PC}:1345",
    "msm_lane": f"{_PC}:1515",
}
KERNELS = tuple(REPLACES)
SEED = 20261016
DEPTH = 253
SMALL_DEPTH = 4
BATCH = 8  # depth-253 proofs in phase 5
GENS_N = 1 << 18  # the padded size: table_w5 generators, msm_win5 words
N1 = 143_704  # depth-253 multipliers: the phase-1 walks
MSM_N = 1 << 14  # phase-2 shapes: msm_w4 points,
PAIR_S = 1024  # frozen side (the pair walks 4 * PAIR_S points),
FOLD_M = 2048  # fold_bits lanes,
LANE_V, LANE_SEG = 16, 2048  # msm_lane segments x points
# digits -16 in windows 0..49 and 1 in window 50
ALL_MINUS_16 = (1 << 250) - 16 * ((1 << 250) - 1) // 31


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        log(f"[{self.name}] start")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.time() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"[{self.name}] {status} in {dt:.2f} s")
        return False


# ------------------------------------------------------------ helpers
def affine(pt, P):
    zi = pow(pt.Z, P - 2, P)
    return pt.X * zi % P, pt.Y * zi % P


def max_abs_err(got, want, P) -> int:
    """Largest |difference| of affine coordinates over two point lists
    (0 when every point is the same Edwards point)."""
    err = 0
    for a, b in zip(got, want, strict=True):
        (ax, ay), (bx, by) = affine(a, P), affine(b, P)
        err = max(err, abs(ax - bx), abs(ay - by))
    return err


def decode_w4(row) -> int:
    total = 0
    for j, word in enumerate(int(v) & 0xFFFFFFFF for v in row):
        for t in range(8):
            nib = (word >> (4 * t)) & 15
            total += (nib - 16 if nib >= 8 else nib) << (4 * (8 * j + t))
    return total


def decode_bits(row) -> int:
    return sum((int(v) & 0xFFFFFFFF) << (32 * j) for j, v in enumerate(row))


def niels_affine(entry_ints, P, D2):
    """(Y+X, Y-X, 2dT, Z) as ints -> affine (x, y); checks 2dT."""
    ypx, ymx, t2d, z = entry_ints
    inv2 = pow(2, P - 2, P)
    X, Y = (ypx - ymx) * inv2 % P, (ypx + ymx) * inv2 % P
    assert t2d * z % P == D2 * X * Y % P, "niels 2dT does not match X, Y"
    zi = pow(z, P - 2, P)
    return X * zi % P, Y * zi % P


def time_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn()  # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_once(torch, fn):
    """(fn(), its wall time in ms), synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000


def random_scalar_rows(bp, n: int, rng):
    return bp.scvec.from_wide_bytes(rng.bytes(64 * n))


def build_tree(bp, depth: int):
    params = bp.PoseidonParams(6, 4, 4, 140)
    tree = bp.VanillaSparseMerkleTree(params, depth=depth)
    for i in range(1, 11):
        tree.update(bp.Scalar(i), bp.Scalar(i))
    return params, tree


def synthesize(bp, params, tree, depth, rng=None, leaf=7, circuit=None):
    """The bench's VSMT-2 membership circuit for `leaf`: compiled tape,
    commitments and witness loaded into a prover.  `circuit` reuses a
    (comp, tape) pair of the same tree."""
    import numpy as np

    k = bp.Scalar(leaf)
    merkle_proof = []
    assert tree.get(k, merkle_proof) == k
    bits = [b.v for b in bp.leaf_index_bit_scalars(k, depth)]
    nodes = list(reversed(merkle_proof))
    if circuit is None:
        comp = bp.CompiledVSMT2(params, depth, constrain_index_bits=False)
        circuit = comp, comp.tape(tree.root)
    comp, tape = circuit
    if rng is None:
        prover = bp.Prover(bp.PedersenGens.default(), bp.Transcript(b"VSMT"))
        comms = comp.commit_prover(prover, k, bits, nodes)
    else:
        prover = bp.Prover(
            bp.PedersenGens.default(), bp.Transcript(b"VSMT"),
            rng=np.random.RandomState(rng),
        )
        comms = comp.commit_prover(
            prover, k, bits, nodes, rng=np.random.RandomState(rng + 1)
        )
    aL, aR, aO = comp.witness(k, bits, nodes)
    prover.load_compiled(tape, aL, aR, aO)
    return comp, tape, comms, prover


def verifier_for(bp, comp, tape, comms):
    verifier = bp.Verifier(bp.Transcript(b"VSMT"))
    comp.commit_verifier(verifier, comms, bp.PedersenGens.default())
    verifier.load_compiled(tape, comp.num_multipliers)
    return verifier


def verify(bp, comp, tape, comms, proof, gens, backend):
    verifier_for(bp, comp, tape, comms).verify(
        proof, bp.PedersenGens.default(), gens, backend=backend
    )


def tampered(bp, proof):
    """The proof with one flipped byte (the IPP's `a` scalar)."""
    raw = bytearray(proof.to_bytes())
    raw[len(raw) - 64] ^= 1
    return bp.R1CSProof.from_bytes(bytes(raw))


# ------------------------------------------------------------- phases
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke runs only on a GPU")
    log(f"device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {card}")
    return card


def phase_kernels(bp, torch, cc, F, gens, dev):
    """Each kernel against its plain version (same CUDA inputs) and a
    subset against the host MSM; returns the per-kernel records."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    P, L = bp.P, bp.L
    records = {}
    G = F.from_raw(gens.G_raw(max(MSM_N, 2 * FOLD_M)), dev)
    H = F.from_raw(gens.H_raw(PAIR_S), dev)
    Bpt = bp.PedersenGens.default().B

    # ---- msm_w4: 2^14 points, random scalars + edge rows
    n = MSM_N
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.chunks import (
        signed_digit_words,
        bit_words,
    )

    rows = random_scalar_rows(bp, n, rng)
    edge = bp.scvec.from_ints([0, 1, L - 1, L - 1, 0, 1])
    rows[: len(edge)] = edge
    words = signed_digit_words(rows)
    words[6] = np.int32(-0x77777778)  # 0x88888888: every digit -8
    words[7, :] = words[6]
    w = torch.from_numpy(words).to(dev)
    acc = F.from_points([Bpt], dev)
    got = cc.msm_w4(G, w, acc)
    torch.cuda.synchronize()
    plain = cc.msm_w4_plain(G, w, acc)
    err = max_abs_err(F.to_points(got), F.to_points(plain), P)
    sub = 64
    sub_got = cc.msm_w4(G[:sub], w[:sub].contiguous(), acc)
    host = bp.multiscalar_mul(
        [bp.Scalar(decode_w4(r) % L) for r in words[:sub]] + [bp.Scalar(1)],
        F.to_points(G[:sub]) + [Bpt],
    )
    assert F.to_points(sub_got)[0] == host, "msm_w4 != host MSM"
    assert err == 0, f"msm_w4 != plain (err {err})"
    records["msm_w4"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: cc.msm_w4(G, w, acc), 5),
        plain_ms=time_ms(torch, lambda: cc.msm_w4_plain(G, w, acc), 1),
    )

    # ---- msm_w4_pair: a frozen pack [G(S) | H(S)] x 2, S = 1024
    S = PAIR_S
    half = 2 * S
    pts = torch.cat([G[:S], H[:S], G[:S], H[:S]]).contiguous()
    prow = random_scalar_rows(bp, 2 * half, rng)
    prow[:2] = bp.scvec.from_ints([0, L - 1])
    pw = torch.from_numpy(signed_digit_words(prow)).to(dev)
    acc2 = F.from_points([Bpt, Bpt.double()], dev)
    err = 0
    for lo, hi in ((0, half), (half // 3, 0), (half, half), (half, half - 5)):
        got = cc.msm_w4_pair(pts, pw, acc2, half, lo, hi)
        plain = cc.msm_w4_pair_plain(pts, pw, acc2, half, lo, hi)
        err = max(err, max_abs_err(F.to_points(got), F.to_points(plain), P))
    assert err == 0, f"msm_w4_pair != plain (err {err})"
    a, b = min(40, half // 2), min(24, half // 2)  # host-checked limits
    got = F.to_points(cc.msm_w4_pair(pts, pw, acc2, half, a, b))
    sc = bp.scvec.to_scalars(prow)
    lo_host = bp.multiscalar_mul(sc[:a], F.to_points(pts[:a])) + Bpt
    hi_host = bp.multiscalar_mul(
        sc[half : half + b], F.to_points(pts[half : half + b])
    ) + Bpt.double()
    assert got[0] == lo_host and got[1] == hi_host, "pair != host MSM"
    records["msm_w4_pair"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: cc.msm_w4_pair(pts, pw, acc2, half), 5),
        plain_ms=time_ms(
            torch,
            lambda: cc.msm_w4_pair_plain(pts, pw, acc2, half, half, half), 1,
        ),
    )

    # ---- fold_bits: 2048 lanes, ones on the left as the IPP folds use
    m = FOLD_M
    left, right = G[:m], G[m : 2 * m]
    srows = random_scalar_rows(bp, m, rng)
    ones = bp.scvec.from_ints([1] * m)
    ones[:3] = bp.scvec.from_ints([0, 0, L - 1])
    srows[:3] = bp.scvec.from_ints([0, 1, 0])
    wl = torch.from_numpy(bit_words(ones)).to(dev)
    wr = torch.from_numpy(bit_words(srows)).to(dev)
    got = cc.fold_bits(left, right, wl, wr)
    plain = cc.fold_bits_plain(left, right, wl, wr)
    gp = F.to_points(got)
    err = max_abs_err(gp, F.to_points(plain), P)
    assert err == 0, f"fold_bits != plain (err {err})"
    lanes = list(range(8)) + [m - 1]
    lpts, rpts = F.to_points(left[lanes]), F.to_points(right[lanes])
    for j, i in enumerate(lanes):
        want = bp.multiscalar_mul(
            [bp.Scalar(decode_bits(wl[i].tolist())),
             bp.Scalar(decode_bits(wr[i].tolist()))],
            [lpts[j], rpts[j]],
        )
        assert gp[i] == want, f"fold_bits lane {i} != host"
    assert gp[0].is_identity(), "fold of two zero scalars is not identity"
    records["fold_bits"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: cc.fold_bits(left, right, wl, wr), 5),
        plain_ms=time_ms(
            torch, lambda: cc.fold_bits_plain(left, right, wl, wr), 1
        ),
    )
    records.update(phase_kernels_w5(bp, torch, cc, F, gens, dev, rng))
    records["msm_lane"] = phase_kernel_lane(bp, torch, cc, F, gens, dev, rng)
    for name, r in records.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
            f"ms, max_abs_err {r['max_abs_err']}")
    return records


def phase_kernels_w5(bp, torch, cc, F, gens, dev, rng):
    """table_w5 over the 2^18 shared generators and msm_win5 over that
    table at the main path's walks; both exact against their plain
    versions, subsets against the host."""
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.chunks import (
        signed_digit5_bytes,
    )

    P, L = bp.P, bp.L
    N = GENS_N
    records = {}
    pts = F.from_raw(gens.G_raw(N), dev)
    tbl = cc.table_w5(pts)
    plain_tbl, plain_ms = timed_once(torch, lambda: cc.table_w5_plain(pts))
    err = 0
    if not torch.equal(tbl, plain_tbl):  # canonical words: equal or not
        err = max(
            abs(a - b) for a, b in zip(
                F.words_to_ints(tbl.cpu().numpy()),
                F.words_to_ints(plain_tbl.cpu().numpy()),
            )
        )
    assert err == 0, f"table_w5 != plain (err {err})"
    del plain_tbl
    checked = [0, 1, N // 2 + 3, N - 1]
    host_pts = F.to_points(pts[checked])
    for i, p in zip(checked, host_pts):  # entries against the host's (k+1)P
        ints = F.words_to_ints(tbl[i].cpu().numpy())
        for k in range(cc.TBL5):
            want = affine(p.scalar_mul(bp.Scalar(k + 1)), P)
            got = niels_affine(ints[4 * k : 4 * k + 4], P, bp.D2)
            assert got == want, f"table_w5 entry {k + 1}P of point {i}"
    records["table_w5"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: cc.table_w5(pts), 5),
        plain_ms=plain_ms,
    )

    # msm_win5: random scalars with 0, 1, L-1 and fifty -16 digits at the
    # start and the end of every walk's word range
    rows = random_scalar_rows(bp, N, rng)
    edge = bp.scvec.from_ints([0, 1, L - 1, ALL_MINUS_16])
    for at in (0, N // 4, N // 2, N1 - 4, N - 4):
        rows[at : at + 4] = edge
    words = torch.from_numpy(signed_digit5_bytes(rows)).to(dev)
    ident = F.identity_points(1, dev)
    chain = F.from_points([bp.PedersenGens.default().B], dev)
    half, vR = N // 2, N1 - N // 2
    walks = [  # (name, chain, walk): the main path's, then a split walk
        ("phase 1", ident, dict(v=N1)),
        ("round 1 G of L", ident, dict(v=half, poff=half, woff=half)),
        ("round 1 G of R", ident, dict(v=vR)),
        ("verifier", chain, dict(v=N)),
        ("split", chain, dict(v=3 * N // 8, poff=9 * N // 16, woff=N // 4,
                              split=N // 4, poff2=N // 64)),
    ]
    err = 0
    for name, acc, kw in walks:
        kw = dict(v=kw["v"], poff=0, woff=0, split=kw["v"], poff2=0) | kw
        got = cc.msm_win5(tbl, words, acc, **kw)
        plain, ms = timed_once(
            torch, lambda: cc.msm_win5_plain(tbl, words, acc, **kw)
        )
        e = max_abs_err(F.to_points(got), F.to_points(plain), P)
        log(f"  msm_win5 {name} {kw}: plain {ms:.1f} ms, max_abs_err {e}")
        if name == "phase 1":
            plain_ms = ms
        err = max(err, e)
    assert err == 0, f"msm_win5 != plain (err {err})"
    sc = bp.scvec.to_scalars(rows)
    sub, cut = 64, 40  # a split walk over both ends of the table
    got = F.to_points(cc.msm_win5(tbl, words, chain, sub, poff=N - cut,
                                  woff=N - sub, split=cut, poff2=half + 5))
    idx = [N - cut + j if j < cut else half + 5 + j - cut for j in range(sub)]
    host = bp.multiscalar_mul(
        sc[N - sub :] + [bp.Scalar(1)],
        F.to_points(pts[idx]) + [bp.PedersenGens.default().B],
    )
    assert got[0] == host, "msm_win5 != host MSM"
    records["msm_win5"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: cc.msm_win5(tbl, words, ident, N1), 5),
        plain_ms=plain_ms,
    )
    return records


def phase_kernel_lane(bp, torch, cc, F, gens, dev, rng):
    """msm_lane over 16 segments of 2048 points, one of them all zero."""
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.chunks import (
        signed_digit_words,
    )

    P, L = bp.P, bp.L
    n = LANE_V * LANE_SEG
    pts = F.from_raw(gens.H_raw(n), dev)
    rows = random_scalar_rows(bp, n, rng)
    rows[:3] = bp.scvec.from_ints([0, 1, L - 1])
    words = torch.from_numpy(signed_digit_words(rows)).to(dev)
    zseg = LANE_V // 3
    words[zseg * LANE_SEG : (zseg + 1) * LANE_SEG] = 0
    got = F.to_points(cc.msm_lane(pts, words, LANE_V))
    plain = F.to_points(cc.msm_lane_plain(pts, words, LANE_V))
    err = max_abs_err(got, plain, P)
    assert err == 0, f"msm_lane != plain (err {err})"
    assert got[zseg].is_identity(), "all-zero segment is not the identity"
    sub = 24  # three small segments against the host MSM
    small = F.to_points(cc.msm_lane(pts[: 3 * sub].contiguous(),
                                    words[: 3 * sub].contiguous(), 3))
    sc = [bp.Scalar(decode_w4(r) % L) for r in words[: 3 * sub].tolist()]
    host_pts = F.to_points(pts[: 3 * sub])
    for s in range(3):
        want = bp.multiscalar_mul(sc[s * sub : (s + 1) * sub],
                                  host_pts[s * sub : (s + 1) * sub])
        assert small[s] == want, f"msm_lane segment {s} != host MSM"
    return dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: cc.msm_lane(pts, words, LANE_V), 5),
        plain_ms=time_ms(
            torch, lambda: cc.msm_lane_plain(pts, words, LANE_V), 1
        ),
    )


def phase_bytes(bp, torch, cc, gens_small):
    params, tree = build_tree(bp, SMALL_DEPTH)
    backend = bp.TorchBackend("cuda")
    comp, tape, comms, prover = synthesize(bp, params, tree, SMALL_DEPTH, 11)
    log(f"  depth {SMALL_DEPTH}: {prover.num_multipliers()} multipliers")
    t0 = time.time()
    proof_dev = prover.prove(gens_small, backend=backend)
    torch.cuda.synchronize()
    log(f"  port prove {time.time() - t0:.2f} s")
    comp, tape, comms_h, prover_h = synthesize(
        bp, params, tree, SMALL_DEPTH, 11
    )
    t0 = time.time()
    proof_host = prover_h.prove(gens_small, backend=None)
    log(f"  host prove {time.time() - t0:.2f} s")
    assert comms == comms_h
    assert proof_dev.to_bytes() == proof_host.to_bytes(), \
        "port proof bytes differ from the host path"
    log(f"  proof bytes identical ({len(proof_dev.to_bytes())} B)")
    verify(bp, comp, tape, comms, proof_dev, gens_small, backend)
    verify(bp, comp, tape, comms, proof_dev, gens_small, None)
    log("  verified by the port's and the host verifier")

    # a batch of three: proof 0 is the prover above (its host proof just
    # matched); proofs 1 and 2 are held against their provers proved alone
    # through the port
    specs = [(7, 11), (3, 21), (9, 31)]  # (leaf, rng seed)
    circuit = (comp, tape)
    alone = [proof_dev] + [
        synthesize(bp, params, tree, SMALL_DEPTH, seed, leaf, circuit)[3]
        .prove(gens_small, backend=backend)
        for leaf, seed in specs[1:]
    ]
    provers = [
        synthesize(bp, params, tree, SMALL_DEPTH, seed, leaf, circuit)[3]
        for leaf, seed in specs
    ]
    lanes = cc.LAUNCHES["msm_lane"]
    t0 = time.time()
    batch = bp.prove_provers(provers, gens_small, backend=backend,
                             host_workers=1)
    torch.cuda.synchronize()
    log(f"  batch of {len(batch)} through prove_provers "
        f"{time.time() - t0:.2f} s, "
        f"{cc.LAUNCHES['msm_lane'] - lanes} flotilla rounds")
    assert cc.LAUNCHES["msm_lane"] > lanes, "no flotilla round ran"
    for i, (got, want) in enumerate(zip(batch, alone)):
        assert got.to_bytes() == want.to_bytes(), \
            f"batched proof {i} differs from the prover proved alone"
    log("  batched proofs byte-identical to the provers proved alone")


def phase_full(bp, torch, cc, gens, params, tree):
    out = {}
    t0 = time.time()
    comp, tape, comms, prover = synthesize(bp, params, tree, DEPTH)
    out["setup_s"] = time.time() - t0
    log(f"  depth {DEPTH}: {prover.num_multipliers()} multipliers, "
        f"tree + synthesis {out['setup_s']:.2f} s")
    snap = prover.snapshot()
    backend = bp.TorchBackend("cuda")
    torch.cuda.reset_peak_memory_stats()
    cc.reset_launches()
    t0 = time.time()
    proof = prover.prove(gens, backend=backend)
    torch.cuda.synchronize()
    out["cold_prove_s"] = time.time() - t0
    t0 = time.time()
    verify(bp, comp, tape, comms, proof, gens, backend)
    torch.cuda.synchronize()
    out["verify_s"] = time.time() - t0
    warm = []
    for _ in range(2):
        prover.restore(snap)
        t0 = time.time()
        prover.prove(gens, backend=backend)
        torch.cuda.synchronize()
        warm.append(time.time() - t0)
    out["warm_prove_s"] = warm
    out["launches"] = dict(cc.LAUNCHES)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  cold prove {out['cold_prove_s']:.2f} s, warm "
        f"{warm[0]:.2f} / {warm[1]:.2f} s, verify {out['verify_s']:.2f} s, "
        f"peak device memory {out['peak_mem_bytes']} B")
    log(f"  launches {out['launches']}")
    for name, count in out["launches"].items():  # all but the flotilla
        assert count > 0 or name == "msm_lane", \
            f"kernel {name} was not launched on the single-proof path"

    # negative cases: a flipped proof byte (the IPP's `a` scalar) and a
    # wrong root must each be rejected
    try:
        verify(bp, comp, tape, comms, tampered(bp, proof), gens, backend)
    except bp.VerificationError:
        log("  tampered proof rejected")
    else:
        raise AssertionError("tampered proof was accepted")
    wrong_tape = comp.tape(bp.Scalar((tree.root.v + 1) % bp.L))
    try:
        verify(bp, comp, wrong_tape, comms, proof, gens, backend)
    except bp.VerificationError:
        log("  wrong root rejected")
    else:
        raise AssertionError("proof verified against a wrong root")
    backend.evict_gens()
    return out


def phase_batch(bp, torch, cc, gens, params, tree):
    """BATCH depth-253 provers (leaves 1..BATCH) through prove_provers,
    one batch_verify, proof 0 against the same prover proved alone, and
    a batch with one tampered proof."""
    import numpy as np

    out = {}
    t0 = time.time()
    comp = bp.CompiledVSMT2(params, DEPTH, constrain_index_bits=False)
    circuit = (comp, comp.tape(tree.root))
    seeds = [SEED + 100 * i for i in range(BATCH)]
    jobs = [
        synthesize(bp, params, tree, DEPTH, seed, i + 1, circuit)
        for i, seed in enumerate(seeds)
    ]
    provers = [j[3] for j in jobs]
    snap = provers[0].snapshot()
    out["setup_s"] = time.time() - t0
    log(f"  {BATCH} provers synthesized in {out['setup_s']:.2f} s")
    backend = bp.TorchBackend("cuda")
    torch.cuda.reset_peak_memory_stats()
    cc.reset_launches()
    t0 = time.time()
    proofs = bp.prove_provers(provers, gens, backend=backend)
    torch.cuda.synchronize()
    out["batch_prove_s"] = time.time() - t0
    out["proofs_per_s"] = BATCH / out["batch_prove_s"]
    out["batch_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  batch of {BATCH}: {out['batch_prove_s']:.2f} s, "
        f"{out['proofs_per_s']:.3f} proofs/s, peak device memory "
        f"{out['batch_peak_mem_bytes']} B")

    pc_gens = bp.PedersenGens.default()
    t0 = time.time()
    bp.batch_verify(
        [verifier_for(bp, comp, j[1], j[2]) for j in jobs], proofs, pc_gens,
        gens, backend=backend,
    )
    torch.cuda.synchronize()
    out["batch_verify_s"] = time.time() - t0
    log(f"  one batch_verify of {BATCH}: {out['batch_verify_s']:.2f} s")
    out["launches"] = dict(cc.LAUNCHES)
    log(f"  launches {out['launches']}")
    for name in ("msm_lane", "msm_win5", "table_w5"):
        assert out["launches"][name] > 0, \
            f"kernel {name} was not launched on the batched path"

    prover = provers[0]
    prover.restore(snap)
    prover.rng = np.random.RandomState(seeds[0])
    alone = prover.prove(gens, backend=backend)
    assert alone.to_bytes() == proofs[0].to_bytes(), \
        "batched proof 0 differs from the prover proved alone"
    log("  proof 0 byte-identical to its prover proved alone")

    bad = list(proofs)
    bad[3] = tampered(bp, proofs[3])
    try:
        bp.batch_verify(
            [verifier_for(bp, comp, j[1], j[2]) for j in jobs], bad, pc_gens,
            gens, backend=backend,
        )
    except bp.VerificationError as exc:
        assert "[3]" in str(exc), f"wrong proof blamed: {exc}"
        log("  batch with a tampered proof rejected (index 3)")
    else:
        raise AssertionError("batch with a tampered proof was accepted")
    backend.evict_gens()
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    with Phase("0 device"):
        card = phase_device(torch)
    import bulletproofs_r1cs_gadgets_tpu_torch as bp
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import build
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F

    log(f"native C++ host library loaded: {bp.NATIVE_LOADED}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with Phase("1 build"):
        t0 = time.time()
        build.load()
        log(f"  kernels built and loaded in {time.time() - t0:.2f} s")
    with Phase("gens"):
        gens = bp.BulletproofGens(1 << 18)
        gens_small = bp.BulletproofGens(1 << 12)
    with Phase("2 kernels vs plain"):
        records = phase_kernels(bp, torch, cc, F, gens, dev)
    with Phase("3 byte identity"):
        phase_bytes(bp, torch, cc, gens_small)
    with Phase("tree"):
        params, tree = build_tree(bp, DEPTH)
    with Phase("4 full proof"):
        full = phase_full(bp, torch, cc, gens, params, tree)
    with Phase("5 batch"):
        batch = phase_batch(bp, torch, cc, gens, params, tree)
    kernels = [
        dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            launches=full["launches"][name] + batch["launches"][name],
            **records[name],
        )
        for name in KERNELS
    ]
    summary = {
        "single": {k: v for k, v in full.items() if k != "launches"},
        "batch": {k: v for k, v in batch.items() if k != "launches"},
    }
    log("summary " + json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.exit(1)
