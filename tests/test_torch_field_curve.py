"""Plain torch field and point arithmetic of the port against Python ints
and ``core.ristretto``; the port's point codecs against the JAX package's
limb layouts (``ops/field.py``, ``ops/chunks.py``, ``BulletproofGens``).

Inputs come from a numpy seed.  Tolerance: exact (equal integers mod p,
equal points, equal words).
"""

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu import BulletproofGens, PedersenGens, Scalar
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import RistrettoPoint
from bulletproofs_r1cs_gadgets_tpu.ops import chunks as jck
from bulletproofs_r1cs_gadgets_tpu.ops import field as jfield
from bulletproofs_r1cs_gadgets_tpu.utils.constants import P
from bulletproofs_r1cs_gadgets_tpu_torch.ops import curve as C
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F

# The plain versions run many small tensor ops: intra-op threads gain
# nothing there and contend with the other test workers' processes.
torch.set_num_threads(1)


def to_points(t: torch.Tensor) -> list[RistrettoPoint]:
    """The port's points of a (n, 4, 8) tensor as the JAX package's
    RistrettoPoints (the reference type the results are held against)."""
    return [RistrettoPoint(p.X, p.Y, p.Z, p.T) for p in F.to_points(t)]

EDGES = [0, 1, 2, 19, P - 1, P, P + 1, 2**255 - 1, 2**256 - 1, 2**256 - 38]


def _values(seed: int, n: int) -> list[int]:
    rng = np.random.RandomState(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    return EDGES + rand


def _limbs(xs) -> torch.Tensor:
    return F.words_to_limbs(torch.from_numpy(F.ints_to_words(xs).copy()))


def _ints(t: torch.Tensor) -> list[int]:
    return F.words_to_ints(F.limbs_to_words(t).numpy())


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "canonical"])
def test_field_ops_match_ints(op):
    a = _values(1, 40)
    b = list(reversed(_values(2, 40)))
    ta, tb = _limbs(a), _limbs(b)
    if op == "add":
        got, want = F.add(ta, tb), [(x + y) % P for x, y in zip(a, b)]
    elif op == "sub":
        # sub takes b with limbs < 2^17: a product output or raw words
        tb = F.mul(tb, _limbs([1] * len(b)))
        got, want = F.sub(ta, tb), [(x - y) % P for x, y in zip(a, b)]
    elif op == "mul":
        got, want = F.mul(ta, tb), [x * y % P for x, y in zip(a, b)]
    elif op == "neg":
        got, want = F.neg(ta), [-x % P for x in a]
    else:
        got, want = ta, [x % P for x in a]
    assert _ints(got) == want


def test_mul_chain_stays_in_range():
    """Products fed straight back into sums and products (the point
    formulas' pattern) keep their limb bounds and stay exact."""
    xs = _values(3, 20)
    t = _limbs(xs)
    want = list(xs)
    for _ in range(6):
        t = F.mul(F.add(t, t), F.sub(F.add(t, t), F.neg(t)))
        want = [(2 * x) * (3 * x) % P for x in want]
        assert int(t.max()) < 1 << 17
    assert _ints(t) == want


def _rand_points(n: int, seed: int) -> list[RistrettoPoint]:
    rng = np.random.RandomState(seed)
    B = PedersenGens.default().B
    return [
        B.scalar_mul(Scalar(int.from_bytes(rng.bytes(31), "little")))
        for _ in range(n)
    ] + [RistrettoPoint.identity()]


def test_point_add_double_negate_match_ristretto():
    p, q = _rand_points(6, 4), list(reversed(_rand_points(6, 5)))
    tp = F.words_to_limbs(F.from_points(p))
    tq = F.words_to_limbs(F.from_points(q))
    add = to_points(F.limbs_to_words(C.point_add_limbs(tp, tq)))
    dbl = to_points(F.limbs_to_words(C.point_double_limbs(tp)))
    mask = torch.tensor([i % 2 == 0 for i in range(len(p))])
    neg = to_points(F.limbs_to_words(C.point_negate(tp, mask)))
    for i in range(len(p)):
        assert add[i] == p[i] + q[i]
        assert dbl[i] == p[i].double()
        assert neg[i] == (-p[i] if i % 2 == 0 else p[i])
    # the formulas are the host's, so even the projective coordinates agree
    assert (add[0].X, add[0].Y, add[0].Z) == (
        (p[0] + q[0]).X, (p[0] + q[0]).Y, (p[0] + q[0]).Z
    )


def test_select_and_block_reduce():
    p = _rand_points(5, 6)
    t = F.words_to_limbs(F.from_points(p))
    total = to_points(F.limbs_to_words(C.block_reduce(t)))[0]
    want = RistrettoPoint.identity()
    for pt in p:
        want = want + pt
    assert total == want
    ident = C.identity(len(p), t.device)
    mask = torch.tensor([True, False, True, False, True, False])
    sel = to_points(F.limbs_to_words(C.point_select_limbs(mask, t, ident)))
    for i, pt in enumerate(sel):
        assert pt == (p[i] if mask[i] else RistrettoPoint.identity())


def test_from_jax_limbs_matches_jax_codec():
    xs = [x % (1 << 264) for x in _values(7, 16)]
    limbs = jfield.ints_to_limbs(xs)  # unbalanced 12-bit
    # balanced limbs straight from the JAX field (a mul output)
    bal = np.asarray(jfield.FP.mul(jfield.FP.to_device(xs),
                                   jfield.FP.to_device(xs[::-1])))
    n = len(xs) // 4 * 4
    got = F.from_jax_limbs(limbs[:n].reshape(-1, 4, jfield.STORE))
    assert F.words_to_ints(got.numpy()) == [x % P for x in xs[:n]]
    got_bal = F.from_jax_limbs(bal[:n].reshape(-1, 4, jfield.STORE))
    assert F.words_to_ints(got_bal.numpy()) == [
        x * y % P for x, y in zip(xs[:n], xs[::-1][:n])
    ]
    assert jfield.FP.to_ints(bal[:n]) == F.words_to_ints(got_bal.numpy())


def test_gens_layouts_agree():
    gens = BulletproofGens(64)
    raw = F.from_raw(gens.G_raw(64))
    via_limbs = F.from_jax_limbs(gens.G_limbs(64))
    assert to_points(raw) == to_points(via_limbs)
    assert torch.equal(F.from_points(gens.H(64)), F.from_raw(gens.H_raw(64)))


def test_from_jax_chunk_round_trip():
    pts = _rand_points(9, 8)
    chunk = jck.points_to_chunks(pts)[0]
    got = F.from_jax_chunk(chunk)
    assert got.shape == (jck.CHUNK, 4, 8)
    back = to_points(got)
    assert back[: len(pts)] == pts
    assert torch.equal(got[len(pts):], F.identity_points(jck.CHUNK - len(pts)))
    assert torch.equal(got[: len(pts)], F.from_points(pts))
