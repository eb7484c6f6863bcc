"""The port's three kernels (plain versions, as CPU tensors route) against
the JAX package's exact host mirrors of the TPU kernels they replace.

Same inputs, made from a numpy seed, go through
``sim_msm_chunk_acc_w4`` / ``sim_msm_grid_pair`` / ``sim_fold_chunk``
(tests/test_ipp_factor_fold.py) in the TPU chunk layout and through
``msm_w4`` / ``msm_w4_pair`` / ``fold_bits`` in the port's flat layout.
Cases cover all-zero rows, digits of -8 (the 8P table entry), scalars 0,
1 and L-1, and pair limits of 0.  The CUDA sources' constants are checked
against the engine's.  Tolerance: exact (equal points).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu import PedersenGens, Scalar
from bulletproofs_r1cs_gadgets_tpu.core import scvec
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import (
    RistrettoPoint,
    multiscalar_mul,
)
from bulletproofs_r1cs_gadgets_tpu.ops import chunks as jck
from bulletproofs_r1cs_gadgets_tpu.ops import pallas_curve as pc
from bulletproofs_r1cs_gadgets_tpu.utils.constants import D2, L, P
from bulletproofs_r1cs_gadgets_tpu_torch.ops import build
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F
from test_ipp_factor_fold import (
    _encode_broadcast,
    _flat,
    _lane_point,
    sim_fold_chunk,
    sim_msm_chunk_acc_w4,
    sim_msm_grid_pair,
)

# The plain versions run many small tensor ops: intra-op threads gain
# nothing there and contend with the other test workers' processes.
torch.set_num_threads(1)


def to_points(t: torch.Tensor) -> list[RistrettoPoint]:
    """The port's points of a (n, 4, 8) tensor as the JAX package's
    RistrettoPoints (the reference type the results are held against)."""
    return [RistrettoPoint(p.X, p.Y, p.Z, p.T) for p in F.to_points(t)]

CHUNK = jck.CHUNK
CSRC = (
    pathlib.Path(__file__).resolve().parent.parent
    / "bulletproofs_r1cs_gadgets_tpu_torch" / "csrc"
)
ALL_MINUS_8 = np.int32(-0x77777778)  # 0x88888888: eight digits of -8


def _points(n: int, seed: int) -> list[RistrettoPoint]:
    rng = np.random.RandomState(seed)
    B = PedersenGens.default().B
    return [
        B.scalar_mul(Scalar(int.from_bytes(rng.bytes(31), "little") + 1))
        for _ in range(n)
    ]


def _scalar_rows(n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return scvec.from_wide_bytes(rng.bytes(64 * n))


def _chunk_words(rows: np.ndarray, nchunks: int = 1) -> np.ndarray:
    """(m, 8) int32 word rows -> JAX word layout (8, 8, 256 * nchunks)."""
    w = np.zeros((nchunks * CHUNK, 8), np.int32)
    w[: rows.shape[0]] = rows
    blocks = [
        np.ascontiguousarray(w[c * CHUNK : (c + 1) * CHUNK].T).reshape(
            8, pc.SUB, pc.LAN_BLOCK
        )
        for c in range(nchunks)
    ]
    return np.concatenate(blocks, axis=2)


def _chunk_points(pts: list[RistrettoPoint], nchunks: int = 1):
    """Points -> JAX chunk array (92, 8, 256 * nchunks), identity padded,
    and the port's flat (nchunks * 2048, 4, 8) tensor of the same points."""
    chunks = jck.points_to_chunks(pts)
    while len(chunks) < nchunks:
        chunks.append(jck.ident_chunk())
    arr = np.concatenate([np.asarray(c) for c in chunks], axis=2)
    flat = torch.cat([F.from_jax_chunk(np.asarray(c)) for c in chunks])
    return arr, flat


def _msm_rows(n: int, seed: int) -> np.ndarray:
    """Signed-digit word rows with the edge cases in front: scalars 0, 1,
    L-1, an all -8 row, then random scalars; a zero row at the end."""
    rows = _scalar_rows(n, seed)
    rows[:3] = scvec.from_ints([0, 1, L - 1])
    w = ck.signed_digit_words(rows)
    w[3] = ALL_MINUS_8
    w[-1] = 0
    return w


def _jax_lane_point(arr, lane: int) -> RistrettoPoint:
    return _lane_point(_flat(arr), lane)


def test_signed_digit_words_match_jax():
    rows = _scalar_rows(300, 1)
    rows[:3] = scvec.from_ints([0, 1, L - 1])
    assert np.array_equal(ck.signed_digit_words(rows),
                          jck.signed_digit_words(rows))
    blk = jck.words_chunks(rows, 1, encode="w4")[0]
    assert np.array_equal(_chunk_words(ck.signed_digit_words(rows)), blk)
    blk_bits = jck.words_chunks(rows, 1)[0]
    assert np.array_equal(_chunk_words(ck.bit_words(rows)), blk_bits)


@pytest.mark.parametrize("n", [1, 24])
def test_msm_w4_matches_tpu_mirror(n):
    pts = _points(n, 10 + n)
    words = _msm_rows(n, 20 + n) if n > 4 else ck.signed_digit_words(
        scvec.from_ints([L - 1])
    )
    acc_pt = _points(1, 3)[0]
    chunk, flat = _chunk_points(pts)
    want = _jax_lane_point(
        sim_msm_chunk_acc_w4(chunk, _chunk_words(words),
                             _encode_broadcast(acc_pt)),
        0,
    )
    got = cc.msm_w4(
        flat[:n].contiguous(), torch.from_numpy(words),
        F.from_points([acc_pt]),
    )
    assert to_points(got)[0] == want
    # the chunk's identity padding with its zero words adds nothing
    pad = 8
    got_pad = cc.msm_w4(
        flat[: n + pad].contiguous(),
        torch.from_numpy(_chunk_words(words).reshape(8, CHUNK).T[: n + pad]
                         .copy()),
        F.from_points([acc_pt]),
    )
    assert to_points(got_pad)[0] == want


@pytest.mark.parametrize(
    "v, lo_limit, hi_limit", [(1, 1, 1), (1, 0, 1), (1, 1, 0), (2, 1, 2)]
)
def test_msm_w4_pair_matches_tpu_mirror(v, lo_limit, hi_limit):
    """Chunks [0, v) -> low accumulator, [v, 2v) -> high; limits count
    chunks on the TPU and points in the port."""
    nz = 6  # live lanes per chunk
    pts, words = [], []
    for c in range(2 * v):
        pts.append(_points(nz, 30 + c))
        words.append(_msm_rows(nz, 40 + c))
    arr = np.concatenate([_chunk_points(p)[0] for p in pts], axis=2)
    flat = torch.cat([_chunk_points(p)[1] for p in pts])
    wrows = np.zeros((2 * v * CHUNK, 8), np.int32)
    for c in range(2 * v):
        wrows[c * CHUNK : c * CHUNK + nz] = words[c]
    acc = _points(2, 50)
    acc2 = np.concatenate(
        [np.asarray(_encode_broadcast(a)) for a in acc], axis=2
    )
    out = sim_msm_grid_pair(
        arr, _chunk_words(wrows, 2 * v), acc2,
        np.array([v, lo_limit, hi_limit], np.int32),
    )
    want = [
        _jax_lane_point(np.asarray(out)[:, :, : pc.LAN_BLOCK], 0),
        _jax_lane_point(np.asarray(out)[:, :, pc.LAN_BLOCK :], 0),
    ]
    half = v * CHUNK
    got = cc.msm_w4_pair(
        flat, torch.from_numpy(wrows), F.from_points(acc), half,
        lo_limit * CHUNK, hi_limit * CHUNK,
    )
    assert to_points(got) == want


def test_fold_bits_matches_tpu_mirror():
    n = 12
    left, right = _points(n, 60), _points(n, 61)
    sl, sr = _scalar_rows(n, 62), _scalar_rows(n, 63)
    sl[:4] = scvec.from_ints([0, 1, 0, L - 1])
    sr[:4] = scvec.from_ints([0, 0, 1, L - 1])
    lchunk, lflat = _chunk_points(left)
    rchunk, rflat = _chunk_points(right)
    out = np.asarray(sim_fold_chunk(
        lchunk, rchunk,
        _chunk_words(ck.bit_words(sl)), _chunk_words(ck.bit_words(sr)),
    ))
    wl, wr = ck.fold_words(sl, "cpu"), ck.fold_words(sr, "cpu")
    got = to_points(cc.fold_bits(
        lflat[:n].contiguous(), rflat[:n].contiguous(), wl, wr
    ))
    for i in range(n):
        assert got[i] == _jax_lane_point(out, i)
        assert got[i] == multiscalar_mul(
            scvec.to_scalars(np.stack([sl[i], sr[i]])), [left[i], right[i]]
        )
    assert got[0].is_identity()


def test_wrappers_check_their_inputs():
    pts = F.identity_points(4)
    words = torch.zeros((4, 8), dtype=torch.int32)
    acc = F.identity_points(1)
    with pytest.raises(ValueError):
        cc.msm_w4(pts, words[:3], acc)
    with pytest.raises(TypeError):
        cc.msm_w4(pts, words.to(torch.int64), acc)
    with pytest.raises(ValueError):
        cc.fold_bits(pts, pts, words.t(), words)
    with pytest.raises(ValueError):
        cc.msm_w4_pair(pts, words, acc, 2)
    meta = pts.to("meta")
    with pytest.raises(ValueError):
        cc.msm_w4(meta, words.to("meta"), acc.to("meta"))
    # CPU tensors take the plain version, which counts no launch
    before = dict(cc.LAUNCHES)
    cc.msm_w4(pts, words, acc)
    assert cc.LAUNCHES == before


def test_kernel_library_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        build.load()


def _cuh_words(name: str) -> int:
    text = (CSRC / "fe25519.cuh").read_text()
    body = re.search(name + r"\[8\]\s*=\s*\{([^}]*)\}", text).group(1)
    words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")
             if w.strip()]
    return sum(w << (32 * i) for i, w in enumerate(words))


def test_cuda_constants_match_engine():
    assert _cuh_words("FE_D2") == D2
    assert _cuh_words("FE_P") == P
    # fold_bits (and smul_lanes and the bit-word MSMs' tiles) read bits 252..0 as the TPU
    # fold does: fold_recode, shared from ge25519_cc.cuh, masks the top word
    # to its low 29 bits before the recoding; scalars are < L
    recode = (CSRC / "ge25519_cc.cuh").read_text()
    assert "w[7] &= 0x1fffffffu" in recode and L < 1 << 253
    assert "fold_recode(wl + 8 * i" in (CSRC / "msm_fold.cu").read_text()
    assert "fold_recode(words + 8 * i" in (CSRC / "msm_fold.cu").read_text()
    assert "fold_recode(words" in (CSRC / "win.cu").read_text()

