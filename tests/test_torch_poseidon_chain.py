"""The device Poseidon kernel's plain versions, wrappers and dispatch
(``cuda_curve.poseidon_permute`` / ``poseidon_chain``, ``csrc/poseidon.cu``)
against the JAX package, on the CPU.

* the plain permute against the JAX package's jitted
  ``DevicePoseidon.permute`` for ``PoseidonParams(6, 4, 4, 8)``, both
  S-boxes, on states holding 0, 1 and l - 1;
* the plain permute at widths 2 to 8 and under any round mask against a
  Python-int permutation (random constants);
* the plain chain against W - 1 calls of ``DevicePoseidon.hash_2`` and
  against the JAX package's host ``Poseidon_hash_2`` chain;
* ``hash_2`` / ``hash_4`` against the JAX package's;
* the wrappers' checks (shape, dtype, width, S-box, rounds), and their
  limits against the kernel source's;
* dispatch: on a CPU tensor ``witness_transform`` makes one chain call and
  no ``mul_fq`` call, ``make_sharded_step`` one chain call a batch row,
  ``hash_2`` / ``hash_4`` one permute call each;
* on a card (marked ``cuda``; skips without one) the kernel against its
  plain version.

The JAX package is imported inside the tests that compare with it, so
that the card case runs on a machine without JAX (``python -m pytest
tests/test_torch_poseidon_chain.py -q -m cuda``).  Tolerance: equal words
(every value is canonical mod l).
"""

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu_torch import carry
from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.poseidon_params import (
    PoseidonParams,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops.field import FQ
from bulletproofs_r1cs_gadgets_tpu_torch.ops.poseidon import DevicePoseidon
from bulletproofs_r1cs_gadgets_tpu_torch.parallel import pipeline
from bulletproofs_r1cs_gadgets_tpu_torch.parallel.mesh import make_mesh
from bulletproofs_r1cs_gadgets_tpu_torch.utils.constants import L

torch.set_num_threads(1)
SMALL = (6, 4, 4, 8)  # width, full rounds at each end, partial rounds: 16 rounds


def count_calls(monkeypatch, names) -> dict:
    """Count each named wrapper's calls (tests/test_torch_backend.py's)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def wrap(*a, _fn=getattr(cc, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(cc, name, wrap)
    return calls


def _rng(seed: int) -> np.random.RandomState:
    return np.random.RandomState(20261019 + seed)


def _ints(rng, n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n)]


def _words(ints, shape) -> torch.Tensor:
    return FQ.to_device(ints, "cpu").reshape(*shape, 8)


def _edge_rows(rng, B: int, w: int) -> list[list[int]]:
    """B rows of w values: random, with 0, 1 and l - 1 among them and a
    zero lane (the inverse S-box's inv(0) = 0)."""
    rows = [_ints(rng, w) for _ in range(B)]
    rows[0][: 3] = [0, 1, L - 1][: w]
    rows[1][-1] = 0
    return rows


def _ref_permute(row, rk, mds, full, sbox):
    """The permutation on Python ints."""
    w = len(row)
    st = list(row)
    for keys, f in zip(rk, full):
        st = [(s + k) % L for s, k in zip(st, keys)]
        box = (lambda x: x * x * x % L) if sbox == "cube" else (
            lambda x: pow(x, L - 2, L))
        st = [box(x) if f or i == w - 1 else x for i, x in enumerate(st)]
        st = [sum(m * x for m, x in zip(mds[i], st)) % L for i in range(w)]
    return st


@pytest.mark.parametrize("sbox", ["cube", "inverse"])
def test_plain_permute_matches_jax_jitted(sbox):
    """PoseidonParams(6, 4, 4, 8) through the JAX package's jitted
    DevicePoseidon.permute and through the port's (the wrapper's plain
    version on the CPU)."""
    from bulletproofs_r1cs_gadgets_tpu.gadgets import poseidon as jposeidon
    from bulletproofs_r1cs_gadgets_tpu.ops.field import FQ as JFQ
    from bulletproofs_r1cs_gadgets_tpu.ops.poseidon import DevicePoseidon as JP
    from test_torch_host import poseidon_arrays

    jp = jposeidon.PoseidonParams(*SMALL)
    params = carry.poseidon_params_from_arrays(**poseidon_arrays(jp))
    rows = _edge_rows(_rng(1), 2, 6)
    flat = [v for r in rows for v in r]
    jax_out = JP(jp, sbox).permute(JFQ.to_device(flat).reshape(2, 6, -1))
    want = carry.field_words(np.asarray(jax_out).reshape(12, -1), L)
    h = DevicePoseidon(params, sbox, device="cpu")
    state = _words(flat, (2, 6))
    assert torch.equal(h.permute(state).reshape(12, 8), want)


@pytest.mark.parametrize("w, mask, sbox", [
    (2, [1, 0, 1], "cube"),
    (5, [0, 0, 1, 0], "cube"),
    (8, [1, 1, 1], "cube"),
    (3, [1, 0], "inverse"),
    (8, [0, 1], "inverse"),
])
def test_plain_permute_any_width_matches_ints(w, mask, sbox):
    """Widths 2 to 8 (the kernel's range) with random round keys and MDS
    and all-full, all-partial and mixed round masks."""
    rng = _rng(10 + w)
    R = len(mask)
    rk = [_ints(rng, w) for _ in range(R)]
    mds = [_ints(rng, w) for _ in range(w)]
    rows = _edge_rows(rng, 3, w)
    got = cc.poseidon_permute(
        _words([v for r in rows for v in r], (3, w)),
        _words([v for r in rk for v in r], (R, w)),
        _words([v for r in mds for v in r], (w, w)),
        torch.tensor(mask, dtype=torch.int32), sbox)
    assert got.shape == (3, w, 8)
    assert FQ.to_ints(got) == [
        v for r in rows for v in _ref_permute(r, rk, mds, mask, sbox)]


@pytest.mark.parametrize("arity", [2, 4])
def test_hash_matches_jax(arity):
    """hash_2 and hash_4 (one hash_state layout, [0, x.., 101, 0..])
    against the JAX package's, both on PoseidonParams(6, 4, 4, 8) with the
    cube S-box."""
    from bulletproofs_r1cs_gadgets_tpu.gadgets import poseidon as jposeidon
    from bulletproofs_r1cs_gadgets_tpu.ops.field import FQ as JFQ
    from bulletproofs_r1cs_gadgets_tpu.ops.poseidon import DevicePoseidon as JP
    from test_torch_host import poseidon_arrays

    jp = jposeidon.PoseidonParams(*SMALL)
    params = carry.poseidon_params_from_arrays(**poseidon_arrays(jp))
    flat = [v for r in _edge_rows(_rng(5), 3, arity) for v in r]
    jx = JFQ.to_device(flat).reshape(3, arity, -1)
    x = _words(flat, (3, arity))
    h = DevicePoseidon(params, "cube", device="cpu")
    if arity == 2:
        jax_out = JP(jp, "cube").hash_2(jx[:, 0], jx[:, 1])
        got = h.hash_2(x[:, 0], x[:, 1])
    else:
        jax_out = JP(jp, "cube").hash_4(jx)
        got = h.hash_4(x)
    assert torch.equal(got, carry.field_words(np.asarray(jax_out), L))


def test_kernel_limits_match_source():
    """The wrappers check the limits csrc/poseidon.cu's launcher checks:
    its lanes a row (the widest state), its shared-memory budget and the
    chain's narrowest width."""
    from pathlib import Path

    src = (Path(cc.__file__).resolve().parent.parent / "csrc"
           / "poseidon.cu").read_text()
    assert f"#define PS_LANES {cc.POSEIDON_MAX_WIDTH} " in src
    assert f"#define PS_MAX_SHARED {cc.POSEIDON_MAX_SHARED} " in src
    assert "w < (CHAIN ? 4 : 2) || w > PS_LANES" in src
    with pytest.raises(ValueError):
        cc._poseidon_consts(*(torch.zeros(s, dtype=torch.int32) for s in (
            (1, 3, 8), (3, 3, 8), (1,))), "cube", torch.device("cpu"), 4)


def test_plain_chain_matches_hash_2_and_host():
    """The flagship hasher's chain over B = 2 paths of W = 3 (a leaf and
    two nodes, one a zero) against W - 1 calls of hash_2 and the JAX
    package's host Poseidon_hash_2 chain (cube S-box)."""
    from bulletproofs_r1cs_gadgets_tpu.core.scalar import Scalar as JScalar
    from bulletproofs_r1cs_gadgets_tpu.gadgets import poseidon as jposeidon

    B, W = 2, 3
    rows = _edge_rows(_rng(2), B, W)
    witness = _words([v for r in rows for v in r], (B, W))
    h = pipeline.flagship_hasher("cpu")
    got = h.chain(witness)
    assert got.shape == (B, 8) and got.is_contiguous()
    acc = witness[:, 0]
    for i in range(1, W):
        acc = h.hash_2(acc, witness[:, i])
    assert torch.equal(got, acc)
    jp = jposeidon.PoseidonParams(6, 4, 4, 140)
    want = []
    for r in rows:
        a = JScalar(r[0])
        for x in r[1:]:
            a = jposeidon.Poseidon_hash_2(a, JScalar(x), jp,
                                          jposeidon.SboxType.Cube)
        want.append(a.v)
    assert FQ.to_ints(got) == want
    # W = 1: no hash, the leaf itself
    assert torch.equal(h.chain(witness[:, :1]), witness[:, 0])


def _bad_case(name):
    """(function, arguments) that the wrappers refuse, by case name."""
    w, R = 6, 3
    st = torch.zeros((2, w, 8), dtype=torch.int32)
    rk = torch.zeros((R, w, 8), dtype=torch.int32)
    mds = torch.zeros((w, w, 8), dtype=torch.int32)
    mask = torch.ones(R, dtype=torch.int32)
    wit = torch.zeros((2, 4, 8), dtype=torch.int32)
    z = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    return {
        "dtype": (cc.poseidon_permute, (st.long(), rk, mds, mask, "cube"),
                  TypeError),
        "state shape": (cc.poseidon_permute, (z(2, 5, 8), rk, mds, mask,
                                              "cube"), ValueError),
        "keys shape": (cc.poseidon_permute, (st, z(R, w, 7), mds, mask,
                                             "cube"), ValueError),
        "mask shape": (cc.poseidon_permute, (st, rk, mds, z(R + 1), "cube"),
                       ValueError),
        "width 9": (cc.poseidon_permute, (z(2, 9, 8), z(R, 9, 8), z(9, 9, 8),
                                          mask, "cube"), ValueError),
        "width 1": (cc.poseidon_permute, (z(2, 1, 8), z(R, 1, 8), z(1, 1, 8),
                                          mask, "cube"), ValueError),
        "sbox": (cc.poseidon_permute, (st, rk, mds, mask, "square"),
                 ValueError),
        "rounds": (cc.poseidon_permute, (z(2, 8, 8), z(1000, 8, 8),
                                         z(8, 8, 8), z(1000), "cube"),
                   ValueError),
        "chain width 3": (cc.poseidon_chain, (wit, z(R, 3, 8), z(3, 3, 8),
                                              mask, "cube"), ValueError),
        "chain width 9": (cc.poseidon_chain, (wit, z(R, 9, 8), z(9, 9, 8),
                                              mask, "cube"), ValueError),
        "chain empty": (cc.poseidon_chain, (z(2, 0, 8), rk, mds, mask,
                                            "cube"), ValueError),
        "chain 2-d": (cc.poseidon_chain, (z(2, 8), rk, mds, mask, "cube"),
                      ValueError),
        "chain dtype": (cc.poseidon_chain, (wit.long(), rk, mds, mask,
                                            "cube"), TypeError),
    }[name]


@pytest.mark.parametrize("name", [
    "dtype", "state shape", "keys shape", "mask shape", "width 9", "width 1",
    "sbox", "rounds", "chain width 3", "chain width 9", "chain empty",
    "chain 2-d", "chain dtype",
])
def test_wrapper_checks(name):
    fn, args, err = _bad_case(name)
    with pytest.raises(err):
        fn(*args)


def test_most_rounds_that_fit():
    """At width 8 the most rounds whose constants fit a block's shared
    memory pass the checks, one more does not."""
    R = (cc.POSEIDON_MAX_SHARED // 4 - 8 * 64) // (8 * 8 + 1)
    z = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    cpu = torch.device("cpu")
    assert cc._poseidon_consts(z(R, 8, 8), z(8, 8, 8), z(R), "inverse", cpu,
                               2) == (8, R, 1)
    with pytest.raises(ValueError):
        cc._poseidon_consts(z(R + 1, 8, 8), z(8, 8, 8), z(R + 1), "cube", cpu,
                            2)


def test_dispatch_one_launch_per_call(monkeypatch):
    """On CPU tensors: witness_transform one chain call and no mul_fq
    call; make_sharded_step over two batch rows one chain call a row;
    hash_2 and hash_4 one permute call each."""
    calls = count_calls(monkeypatch, ("poseidon_chain", "poseidon_permute",
                                      "mul_fq"))
    rows = _edge_rows(_rng(3), 2, 2)
    witness = _words([v for r in rows for v in r], (2, 2))
    digest = pipeline.witness_transform(witness)
    assert calls == {"poseidon_chain": 1, "poseidon_permute": 0, "mul_fq": 0}
    h = pipeline.flagship_hasher("cpu")
    assert torch.equal(digest, h.hash_2(witness[:, 0], witness[:, 1]))
    assert calls["poseidon_permute"] == 1
    h.hash_4(torch.cat([witness, witness], dim=1))
    assert calls["poseidon_permute"] == 2
    mesh = make_mesh(devices=["cpu", "cpu"], batch_axis=2)
    step = pipeline.make_sharded_step(mesh)
    pts = torch.zeros((2, 4, 8), dtype=torch.int32)
    pts[:, 1, 0] = pts[:, 2, 0] = 1  # the identity
    got, _, _ = step(witness, pts, torch.ones((2, 4), dtype=torch.int32))
    assert torch.equal(got, digest)
    assert calls["poseidon_chain"] == 3 and calls["mul_fq"] == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On the card: both entry points against their plain versions on
    the same inputs, both S-boxes, edge values, all-full and mixed masks,
    rows past a block (B = 37), one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    params = PoseidonParams(*SMALL)
    rng = _rng(4)
    for sbox in ("cube", "inverse"):
        h = DevicePoseidon(params, sbox, device=dev)
        consts = h._consts()
        state = _words([v for r in _edge_rows(rng, 37, 6) for v in r],
                       (37, 6)).to(dev)
        before = dict(cc.LAUNCHES)
        got = h.permute(state)
        assert torch.equal(got, cc.poseidon_permute_plain(state, *consts))
        full = (torch.ones_like(consts[2]),) + consts[3:]
        assert torch.equal(cc.poseidon_permute(state, *consts[:2], *full),
                           cc.poseidon_permute_plain(state, *consts[:2], *full))
        witness = _words([v for r in _edge_rows(rng, 5, 3) for v in r],
                         (5, 3)).to(dev)
        assert torch.equal(h.chain(witness),
                           cc.poseidon_chain_plain(witness, *consts))
        ran = {k: cc.LAUNCHES[k] - before[k] for k in before}
        assert {k: v for k, v in ran.items() if v} == {
            "poseidon_permute": 2, "poseidon_chain": 1}
