"""The redesigned smul_lanes and the pointwise group operations, on the CPU.

``smul_lanes`` (``csrc/msm_fold.cu``) now recodes each bit word row in
the kernel into 64 signed base-16 digits (``fold_recode``: bits 252..0,
the top digit taking the carry, a zero row staying zero) and runs Straus
over an 8-entry niels table of the lane's point, in two designs:

* ``thread``: one thread a lane; the table 2P = dbl P, then t(k-1) + P;
  windows 63..0 of 4 doublings (T on the 4th) once a digit was added, and
  a niels add per nonzero digit;
* ``group``: ``fold_bits``' cooperative table (odd multiples doubled, even
  ones t(k-1) + P) and window loop with one table, four lanes a warp
  (groups past n repeat lane n - 1): the warp doubles once any group
  added and adds when any group's digit is nonzero (the identity for the
  others).

Each model runs in torch, step for step, and is held against
``smul_lanes_plain`` (the TPU's bit ladder, itself held against the JAX
ladder in ``tests/test_torch_oracle_kernels.py``) and, on a subset, the
host ``RistrettoPoint`` scalar multiply.  ``padd`` / ``pdbl``
(``csrc/oracle.cu``) keep the plain versions' formulas on the carry-chain
multiply, so their words are the plain versions': those are held here on
coordinates in [p, 2^256), the identity and a point plus its negation,
against the host group law.  Tolerance: exact (the same Edwards point,
X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1, for the models; equal words for the
pointwise operations).
"""

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu_torch import (
    BulletproofGens,
    L,
    P,
    Scalar,
    scvec,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import curve as C
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F
from test_torch_fold_bits import niels_tables
from test_torch_ladder import no_t, same_points
from test_torch_oracle_redesign import _value_bits, bit_codes

torch.set_num_threads(1)

WARP = 4  # smul_lanes' group design: lanes a warp, 8 threads each
HIGH_BITS = -0x20000000  # 0xe0000000: bits 253..255 of word 7 (not read)


# ------------------------------------------------------------- smul_lanes
def _doubled4(acc: torch.Tensor) -> torch.Tensor:
    for d in range(4):
        acc = C.point_double_limbs(acc)
        if d < 3:
            acc = no_t(acc)
    return acc


def _entry(table: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """The niels entry a digit code selects from (m, 8, 4, 16) tables:
    entry |d| - 1, negated for d < 0 (code 0 selects entry 0: unused)."""
    neg = code >= 8
    mag = torch.where(neg, 16 - code, code)
    rows = torch.arange(table.shape[0])
    return C.niels_negate(table[rows, (mag - 1).clamp(min=0)], neg)


def thread_table(p: torch.Tensor) -> torch.Tensor:
    """(m, 4, 16) limbs -> (m, 8, 4, 16) niels entries (k + 1) P in the
    thread design's order: 2P = dbl P, then t(k-1) + P."""
    nP = C.to_niels(p)
    e = [nP]
    x = C.point_double_limbs(p)
    e.append(C.to_niels(x))
    for _ in range(6):
        x = C.point_add_niels(x, nP)
        e.append(C.to_niels(x))
    return torch.stack(e, dim=1)


def smul_thread_model(points, words) -> torch.Tensor:
    """smul_lanes' thread design: per lane its table, then windows 63..0
    of 4 doublings once a digit was added and a niels add per nonzero
    digit (code 0 adds nothing)."""
    n = points.shape[0]
    table = thread_table(F.words_to_limbs(points))
    codes = torch.from_numpy(bit_codes(words.numpy()))
    acc = C.identity(n, "cpu")
    started = torch.zeros(n, dtype=torch.bool)
    for pos in range(63, -1, -1):
        acc = torch.where(started[:, None, None], _doubled4(acc), acc)
        c = codes[:, pos]
        added = C.point_add_niels(acc, _entry(table, c))
        acc = torch.where((c != 0)[:, None, None], added, acc)
        started |= c != 0
    return F.limbs_to_words(acc)


def smul_group_model(points, words) -> torch.Tensor:
    """smul_lanes' group design: groups past n repeat lane n - 1,
    fold_bits' niels table, the warp's 64 windows (a doubling once any
    group added, an add when any group's digit is nonzero, the identity
    for the others)."""
    n = points.shape[0]
    idx = torch.cat([torch.arange(n), torch.full((-n % WARP,), n - 1)])
    m = idx.numel()
    warp = torch.arange(m) // WARP
    table = niels_tables(F.words_to_limbs(points[idx]))
    codes = torch.from_numpy(bit_codes(words.numpy()))[idx]
    ident = C.to_niels(C.identity(m, "cpu"))
    acc = C.identity(m, "cpu")
    started = torch.zeros(m // WARP, dtype=torch.bool)
    for win in range(63, -1, -1):
        acc = torch.where(started[warp][:, None, None], _doubled4(acc), acc)
        c = codes[:, win]
        need = (c != 0).view(-1, WARP).any(dim=1)
        q = torch.where((c != 0)[:, None, None], _entry(table, c), ident)
        acc = torch.where(need[warp][:, None, None], C.point_add_niels(acc, q), acc)
        started |= need
    return F.limbs_to_words(acc)[:n]


SMUL_MODELS = {"thread": smul_thread_model, "group": smul_group_model}
EDGES = {"zero": 0, "one": 1, "L-1": L - 1, "2^253-1": (1 << 253) - 1}


def smul_inputs(kind: str, n: int, seed: int):
    """n generators and bit word rows: random scalars with row 0 the edge
    `kind` (an EDGES scalar, or ``high``: a random scalar with bits
    253..255 set, which are not read), or all random."""
    pts = F.from_raw(BulletproofGens(n).G_raw(n))
    words = ck.bit_words(scvec.from_wide_bytes(
        np.random.RandomState(seed).bytes(64 * n))).copy()
    if kind in EDGES:
        words[0] = np.frombuffer(EDGES[kind].to_bytes(32, "little"), "<i4")
    elif kind == "high":
        words[0, 7] |= HIGH_BITS
    return pts, torch.from_numpy(words)


@pytest.mark.parametrize("design", sorted(SMUL_MODELS))
@pytest.mark.parametrize("kind", [*EDGES, "high", "random"])
@pytest.mark.parametrize("n", [1, 3, 17])
def test_smul_model_matches_plain(design, kind, n):
    """Both designs at n = 1 (three dummy groups), 3 and 17 (a ragged last
    warp), row 0 an edge scalar (0, 1, L - 1, 2^253 - 1, bits 253..255
    set) or random: the same group elements as the bit ladder."""
    pts, words = smul_inputs(kind, n, 800 + n)
    got = SMUL_MODELS[design](pts, words)
    assert same_points(got, cc.smul_lanes_plain(pts, words))
    if kind == "zero":
        assert F.to_points(got[:1])[0].is_identity()


def test_smul_models_match_host():
    """Both designs' orders against the host scalar multiply on the edge
    rows, bits 253..255 dropped (2^253 - 1 taken mod L)."""
    rows = [*EDGES.values(), None]
    n = len(rows)
    pts, words = smul_inputs("random", n, 810)
    for i, val in enumerate(rows):
        if val is None:
            words[i, 7] |= HIGH_BITS
        else:
            words[i] = torch.from_numpy(np.frombuffer(val.to_bytes(32, "little"), "<i4").copy())
    host = F.to_points(pts)
    want = [p.scalar_mul(Scalar(_value_bits(w) % L))
            for p, w in zip(host, words.tolist())]
    for design, model in SMUL_MODELS.items():
        assert F.to_points(model(pts, words)) == want, design


def test_smul_lanes_design_names():
    """The wrapper's design names: None lets the library choose; anything
    else is refused before any launch."""
    assert [cc._design_number("smul_lanes", cc.SMUL_LANES_DESIGNS, d)
            for d in (None, *cc.SMUL_LANES_DESIGNS)] == [-1, 0, 1]
    pts = F.identity_points(2)
    w = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        cc.smul_lanes(pts, w, design="ladder")
    got = F.to_points(cc.smul_lanes(pts, w, design="group"))
    assert all(x.is_identity() for x in got)


# --------------------------------------------------------- padd / pdbl
def plus_p(words: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """(n, 4, 8) int32 coordinates with p added to each coordinate where
    `mask` (n, 4) is set: the same residues in [p, 2^256) (coordinates
    below 2^256 - p)."""
    w = words.view(np.uint32).astype(np.uint64)
    pw = np.array([(P >> (32 * k)) & 0xFFFFFFFF for k in range(8)], np.uint64)
    out = np.empty_like(w)
    carry = np.zeros(w.shape[:2], np.uint64)
    for k in range(8):
        s = w[..., k] + pw[k] * mask + carry
        out[..., k] = s & 0xFFFFFFFF
        carry = s >> np.uint64(32)
    assert not carry.any(), "a coordinate reached 2^256"
    return out.astype(np.uint32).view(np.int32)


def pointwise_inputs(n: int, seed: int):
    """(a, b, a', b'): n points a and b (the first 1,024 generators of G
    and of H, repeated) with the identity at row 1 of a and -a[2] at row 2
    of b (when n allows), and a', b' the same points with p added to
    random coordinates (every coordinate of row 0)."""
    m = min(n, 1024)
    g = BulletproofGens(m)
    reps = -(-n // m)
    a = F.from_raw(g.G_raw(m)).repeat(reps, 1, 1)[:n].contiguous()
    b = F.from_raw(g.H_raw(m)).repeat(reps, 1, 1)[:n].contiguous()
    if n > 1:
        a[1] = F.identity_points(1)[0]
    if n > 2:
        b[2] = F.from_points([-F.to_points(a[2:3])[0]])[0]
    rng = np.random.RandomState(seed)
    out = []
    for t in (a, b):
        mask = rng.randint(0, 2, (n, 4)).astype(np.uint64)
        mask[0] = 1
        out.append(torch.from_numpy(plus_p(t.numpy(), mask)))
    return a, b, *out


@pytest.mark.parametrize("n", [1, 3, 17])
def test_padd_pdbl_plain_on_noncanonical_inputs(n):
    """padd_plain / pdbl_plain on coordinates in [p, 2^256) give the words
    of the canonical inputs (every output canonical), and the host group
    law's points: a + b, 2a, the identity's sum and double, P + (-P) the
    identity."""
    a, b, a2, b2 = pointwise_inputs(n, 820 + n)
    assert not torch.equal(a2, a) and not torch.equal(b2, b)
    add, dbl = cc.padd_plain(a2, b2), cc.pdbl_plain(a2)
    assert torch.equal(add, cc.padd_plain(a, b))
    assert torch.equal(dbl, cc.pdbl_plain(a))
    for got in (add, dbl):
        ints = F.words_to_ints(got.numpy())
        assert all(0 <= x < P for x in ints)
    ha, hb = F.to_points(a), F.to_points(b)
    assert F.to_points(add) == [x + y for x, y in zip(ha, hb)]
    assert F.to_points(dbl) == [x.double() for x in ha]
    if n > 2:
        assert F.to_points(add[1:2]) == [hb[1]]
        assert F.to_points(dbl[1:2])[0].is_identity()
        assert F.to_points(add[2:3])[0].is_identity()
    ident = F.identity_points(1)
    for got in (cc.pdbl_plain(ident), cc.padd_plain(ident, ident)):
        assert F.to_points(got)[0].is_identity()
