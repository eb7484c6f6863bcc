"""The plain reference against the port, on the CPU at tiny depths: it
accepts the port's proofs (its plain kernel versions, and its host
backend, which gives the same bytes) and rejects a proof with one byte
flipped, one for other commitments and one against another tree."""

import random

import numpy as np
import pytest
import torch

from benchmark.reference import curve, field as fe, poseidon as rp
from benchmark.reference.verify import Reference

L = rp.L
POSEIDON = dict(width=6, full_rounds_beginning=4, partial_rounds=140,
                full_rounds_end=4)


def test_field_matches_python_ints():
    rnd = random.Random(1)
    P = fe.P
    xs = [rnd.randrange(P) for _ in range(40)] + [0, 1, P - 1, P - 19]
    ys = [rnd.randrange(P) for _ in xs]
    a, b = fe.from_ints(xs, "cpu"), fe.from_ints(ys, "cpu")
    assert fe.to_ints(fe.mul(a - b, a + b + b)) == [
        (x - y) * (x + 2 * y) % P for x, y in zip(xs, ys)]
    assert fe.to_ints(fe.invert(a)) == [pow(x, P - 2, P) for x in xs]
    raw = torch.tensor([list(x.to_bytes(32, "little")) for x in xs],
                       dtype=torch.uint8)
    assert fe.to_ints(fe.from_bytes(raw)) == xs
    assert torch.equal(fe.to_bytes(a), raw)


def test_group_matches_the_port_host_arithmetic():
    import bulletproofs_r1cs_gadgets_tpu_torch as bp
    from bulletproofs_r1cs_gadgets_tpu_torch.core.ristretto import RistrettoPoint

    rnd = random.Random(2)
    pts = [RistrettoPoint.basepoint().scalar_mul(bp.Scalar(rnd.randrange(1, L)))
           for _ in range(8)]
    enc = torch.tensor([list(p.compress()) for p in pts], dtype=torch.uint8)
    got, ok = curve.decompress(enc)
    assert bool(ok.all()) and torch.equal(curve.compress(got), enc)
    bad = enc.clone()
    bad[:, 0] ^= 1  # odd encodings are never valid
    assert not bool(curve.decompress(bad)[1].any())
    gens = bp.BulletproofGens(16)
    G = curve.generator_chain(b"G" + bytes(4), 16, "cpu")
    assert [bytes(r.tolist()) for r in curve.compress(G)] == [
        p.compress() for p in gens.share(0).G(16)]
    sc = [rnd.randrange(L) for _ in pts]
    want = pts[0].scalar_mul(bp.Scalar(sc[0]))
    for p, k in zip(pts[1:], sc[1:]):
        want = want + p.scalar_mul(bp.Scalar(k))
    assert RistrettoPoint(*curve.msm(got, sc, lane_chunk=3)) == want


def _port_case(kind, depth, items, key, backend):
    import bulletproofs_r1cs_gadgets_tpu_torch as bp
    from bulletproofs_r1cs_gadgets_tpu_torch.models import compiled, vsmt4

    params = bp.PoseidonParams(6, 4, 4, 140)
    if kind == "vsmt2":
        tree = bp.VanillaSparseMerkleTree(params, depth=depth)
        comp = compiled.CompiledVSMT2(params, depth, constrain_index_bits=False)
    else:
        tree = vsmt4.VanillaSparseMerkleTree4(params, depth=depth)
        comp = compiled.CompiledVSMT4(params, depth)
    for k, v in items.items():
        tree.update(bp.Scalar(k), bp.Scalar(v))
    path = []
    leaf = tree.get(bp.Scalar(key), path)
    prover = bp.Prover(bp.PedersenGens.default(), bp.Transcript(b"VSMT"),
                       rng=np.random.RandomState(11))
    blind = np.random.RandomState(12)
    if kind == "vsmt2":
        bits = [(key >> i) & 1 for i in range(depth)]
        nodes = list(reversed(path))
        comms = comp.commit_prover(prover, leaf, bits, nodes, rng=blind)
        wires = comp.witness(leaf, bits, nodes)
    else:
        nodes = [x for level in path for x in level]
        comms = comp.commit_prover(prover, leaf, bp.Scalar(key), nodes, rng=blind)
        wires = comp.witness(leaf, bp.Scalar(key), nodes)
    prover.load_compiled(comp.tape(tree.root), *wires)
    gens = bp.BulletproofGens(1 << (comp.num_multipliers - 1).bit_length())
    proof = prover.prove(gens, backend=backend)
    return dict(key=key, value=items[key], blind_seed=12, comms=comms,
                proof=proof.to_bytes())


def _judge(kind, depth, items, cases, seed=5):
    ref = Reference(dict(circuit=kind, depth=depth, transcript_label="VSMT",
                         poseidon=POSEIDON), "cpu")
    return ref.judge(items, cases, seed)


def _flipped(case):
    raw = bytearray(case["proof"])
    raw[len(raw) - 64] ^= 1
    return dict(case, proof=bytes(raw))


def test_reference_accepts_the_plain_versions_proof():
    import bulletproofs_r1cs_gadgets_tpu_torch as bp

    items = {0: 7, 1: 9}
    case = _port_case("vsmt2", 1, items, 1, bp.TorchBackend("cpu"))
    got = _judge("vsmt2", 1, items, [case])
    assert (got["proofs_rejected"], got["commitments_differ"]) == (0, 0)
    assert _judge("vsmt2", 1, items, [_flipped(case)])["proofs_rejected"] == 1


@pytest.mark.parametrize("kind,depth", [("vsmt2", 4), ("vsmt4", 4)])
def test_reference_judges_the_port(kind, depth):
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import NativeBackend

    rnd = random.Random(3)
    arity = 2 if kind == "vsmt2" else 4
    items = {}
    while len(items) < 5:
        items[rnd.randrange(arity ** depth)] = rnd.randrange(L)
    key = list(items)[2]
    case = _port_case(kind, depth, items, key, NativeBackend())
    good = _judge(kind, depth, items, [case, dict(case)])
    assert (good["proofs_rejected"], good["commitments_differ"]) == (0, 0)
    assert _judge(kind, depth, items, [case, _flipped(case)])["proofs_rejected"] == 1
    other = dict(items)
    other[list(items)[0]] = (other[list(items)[0]] + 1) % L
    moved = _judge(kind, depth, other, [case])
    assert moved["proofs_rejected"] == 1 and moved["commitments_differ"] >= 1
    reblind = _judge(kind, depth, items, [dict(case, blind_seed=13)])
    assert reblind["proofs_rejected"] == 1


def test_trees_match_the_port():
    import bulletproofs_r1cs_gadgets_tpu_torch as bp
    from bulletproofs_r1cs_gadgets_tpu_torch.models import vsmt4

    params = bp.PoseidonParams(6, 4, 4, 140)
    p = rp.Params(6, 4, 140, 4)
    rnd = random.Random(4)
    for arity, depth, port in ((2, 6, bp.VanillaSparseMerkleTree),
                               (4, 4, vsmt4.VanillaSparseMerkleTree4)):
        items = {rnd.randrange(arity ** depth): rnd.randrange(L)
                 for _ in range(4)}
        tree = port(params, depth=depth)
        for k, v in items.items():
            tree.update(bp.Scalar(k), bp.Scalar(v))
        assert rp.Tree(arity, depth, items, p).root == tree.root.v


@pytest.mark.cuda
def test_card_arithmetic_matches_the_cpu(card):
    rnd = random.Random(5)
    xs = [rnd.randrange(fe.P) for _ in range(64)]
    a = fe.from_ints(xs, "cpu")
    assert fe.to_ints(fe.invert(a.to(card))) == fe.to_ints(fe.invert(a))
    raw = torch.from_numpy(np.frombuffer(
        bytes(rnd.randrange(256) for _ in range(64 * 16)),
        dtype=np.uint8).reshape(16, 64).copy())
    assert torch.equal(curve.compress(curve.from_uniform(raw.to(card))).cpu(),
                       curve.compress(curve.from_uniform(raw)))
