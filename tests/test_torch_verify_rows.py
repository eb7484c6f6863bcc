"""The verifier's G/H rows built on the backend's device (``ops/verify_rows.py``).

On a CPU ``TorchBackend`` the four kernels (``sc_powers``, ``tape_flatten``,
``tape_sums``, ``gh_rows``) run their plain versions; here each is held
against the host path's arrays row for row: the tape's CSR against its
terms, ``TapeArrays.flatten``'s wL / wR / wO / wV / wc, y^-i, the IPP's s
vector, delta, ``_verification_job``'s g, h, head and B rows, and the words
``chunks.w5_words`` makes of g and h.  The circuits: the depth-4 VSMT-2
golden circuit (2,272 multipliers padded to 4,096) and a two-phase circuit
(phase-2 multipliers, so u_g = u from n1 < n, and padding).  A batch's
rows (``gh_rows`` over B row sets, each weighted by its rho) equal the
host's rho-weighted sum of its jobs' g and h, at B = 1, 2 and 8 over
distinct transcripts, and over two padded sizes.  A verification
through the device rows accepts a good proof and rejects a flipped byte
and a wrong root; a backend without the capability and the sizes it does
not serve keep the host's rows.  Tolerance: exact.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import bulletproofs_r1cs_gadgets_tpu_torch as bp
import chip_smoke as cs
from bulletproofs_r1cs_gadgets_tpu_torch import scvec
from bulletproofs_r1cs_gadgets_tpu_torch.core import verifier as vmod
from bulletproofs_r1cs_gadgets_tpu_torch.core.ipp import InnerProductProof
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import verify_rows as vr
from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import (
    NativeBackend,
)
from bulletproofs_r1cs_gadgets_tpu_torch.utils import metrics

PC = bp.PedersenGens.default()
ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "bulletproofs_r1cs_gadgets_tpu_torch" / "csrc" / "verify_rows.cu"


def cpu_backend(**kw) -> bp.TorchBackend:
    """Every device branch at small sizes: the walker range from 1."""
    return bp.TorchBackend("cpu", min_device_n=1, walker_min_n=1, **kw)


# ------------------------------------------------------------- circuits
def _two_phase(cs_, vals, links, value=None):
    """Commitments `vals`, a chain of `links` multipliers, and 11 phase-2
    multipliers on a challenge: v_j * ch == w_j."""
    if value is None:
        vs = [cs_.commit(c) for c in vals]
    else:
        vs = [cs_.commit(v, bp.Scalar(7 + j))[1] for j, v in enumerate(vals)]
    _, _, o = cs_.multiply(vs[0], vs[1])
    for _ in range(links):
        _, _, o = cs_.multiply(o + bp.Scalar(1), o + bp.Scalar(2))

    def deferred(rcs):
        ch = rcs.challenge_scalar(b"rand")
        for j in range(11):
            v = vs[j % len(vs)]
            if value is None:
                a, b, out = rcs.allocate_multiplier(None)
            else:
                prod = value[j % len(vs)] * ch
                a, b, out = rcs.allocate_multiplier((prod, bp.Scalar.one()))
            rcs.constrain(a - v * ch)
            rcs.constrain(b - bp.Scalar.one())
            rcs.constrain(out - v * ch)

    cs_.specify_randomized_constraints(deferred)


def two_phase_case(links: int = 40) -> cs.Case:
    """A two-phase circuit: 41 phase-1 and 11 phase-2 multipliers, padded
    to 64."""
    vals = [bp.Scalar(17), bp.Scalar(19), bp.Scalar(23)]
    prover = bp.Prover(PC, bp.Transcript(b"TwoPhaseRows"))
    _two_phase(prover, vals, links, value=vals)
    comms = [PC.commit(v, bp.Scalar(7 + j)).compress()
             for j, v in enumerate(vals)]
    gens = bp.BulletproofGens(64)
    proof = prover.prove(gens)

    def verifier(chain):
        v = bp.Verifier(bp.Transcript(b"TwoPhaseRows"))
        _two_phase(v, comms, chain)
        return v

    return cs.Case(proof, gens, lambda: verifier(links),
                   lambda: verifier(links - 1))


@pytest.fixture(scope="module")
def golden():
    # chip_smoke's VSMT-2 circuit; the bytes of any backend
    return cs.vsmt2_case(bp, cs.SMALL_DEPTH, NativeBackend())


@pytest.fixture(scope="module")
def two_phase():
    return two_phase_case()


# ------------------------------------------------------- host against rows
class Spy:
    """Records the VerifyRows a verification builds and its z and y^-1."""

    def __init__(self, monkeypatch):
        self.rows = []
        flatten = vr.VerifyRows.flatten

        def spy(rows, z, y_inv):
            rows.z, rows.y_inv = z, y_inv
            self.rows.append(rows)
            return flatten(rows, z, y_inv)

        monkeypatch.setattr(vr.VerifyRows, "flatten", spy)


def _fixed_r(monkeypatch):
    """The verifier's random combining factor, fixed: the host and device
    jobs of one proof then agree on every scalar."""
    monkeypatch.setattr(vmod.secrets, "token_bytes", lambda k: bytes(range(k)))


def _words(rows: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rows, "<u8").view("<i4"))


def host_s(u_sq, all_inv, N: int) -> np.ndarray:
    """The IPP's s vector by ``verification_scalars_arrays``' doublings."""
    k = len(u_sq)
    assert N == 1 << k
    s = scvec.from_scalars([all_inv])
    for j in range(k):
        s = np.concatenate([s, scvec.scale(s, u_sq[k - 1 - j])])
    return s


def jobs(case: cs.Case, backend, monkeypatch):
    """(host job, device job, its VerifyRows, the device job's verifier)
    for one proof, with the combining factor fixed."""
    _fixed_r(monkeypatch)
    spy = Spy(monkeypatch)
    host = case.verifier()._verification_job(case.proof, PC, case.gens)
    v = case.verifier()
    dev = v._verification_job(case.proof, PC, case.gens, backend.verify_rows)
    assert dev.g is None and dev.h is None and spy.rows == [dev.rows]
    return host, dev, dev.rows, v


CIRCUITS = ["golden", "two_phase"]


@pytest.mark.parametrize("circuit", CIRCUITS)
def test_device_rows_equal_the_host_arrays(circuit, request, monkeypatch):
    case = request.getfixturevalue(circuit)
    host, dev, rows, v = jobs(case, cpu_backend(), monkeypatch)
    n, n1, N, nv = rows.n, rows.n1, rows.N, len(v.V)
    assert (n, n1, N) == (v.num_vars, v.num_phase1_multipliers, host.padded_n)
    if circuit == "two_phase":
        assert n1 < n < N
    # the head, B and tail rows
    assert np.array_equal(dev.head_sc, host.head_sc)
    assert np.array_equal(dev.B_scalar_row, host.B_scalar_row)
    assert np.array_equal(dev.B_blinding_row, host.B_blinding_row)
    assert np.array_equal(dev.tail_sc, host.tail_sc)
    assert rows.with_scalars(dev) is rows
    assert np.array_equal(rows.head, np.concatenate(
        [host.head_sc, host.B_scalar_row[None], host.B_blinding_row[None]]))
    assert np.array_equal(rows.tail, host.tail_sc)
    # the tape's CSR: each wire's terms, in tape order
    tape, dt = v._tape_memo, rows.tape
    off = dt.off.numpy()
    base = 0
    for (c, w, co), size in ((tape.lc, n), (tape.rc, n), (tape.oc, n),
                             (tape.vc, nv)):
        counts = np.diff(off[base : base + size + 1])
        assert np.array_equal(counts, np.bincount(w, minlength=size))
        order = np.argsort(w, kind="stable")
        lo, hi = off[base], off[base + size]
        assert np.array_equal(dt.cidx.numpy()[lo:hi], c[order])
        assert torch.equal(dt.coeff[lo:hi], _words(co[order]))
        base += size
    assert torch.equal(dt.ccoeff, _words(tape.onec[2]))
    # the flatten, the powers and the sums
    wL, wR, wO, wV, wc = tape.flatten(rows.z, n, nv, want_wc=True)
    assert torch.equal(rows.wires, _words(np.concatenate([wL, wR, wO, wV])))
    yinv = scvec.powers(rows.y_inv, N)
    assert torch.equal(rows.yinv, _words(yinv))
    got_wV, got_wc, got_delta = rows.sums()
    assert np.array_equal(got_wV, wV)
    assert got_wc == wc
    assert got_delta == scvec.inner(scvec.mul(yinv[:n], wR), wL)
    # s, g and h, then the walker's words
    u_sq, all_inv = rows._s
    s = cc.sc_powers(*vr.s_tables(u_sq, all_inv, "cpu"), N)
    assert torch.equal(s, _words(host_s(u_sq, all_inv, N)))
    consts = vr._words(rows._consts, "cpu")
    g, h = cc.gh_scalars_plain(rows.wires, rows.yinv, s, consts, n, n1)
    assert torch.equal(g, _words(host.g))
    assert torch.equal(h, _words(host.h))
    want = torch.cat([ck.w5_words(host.g, "cpu"), ck.w5_words(host.h, "cpu")])
    assert torch.equal(rows.words(), want)


def variant(proof, b: int):
    """`proof` with its eight phase-1 and T points rotated by b over their
    slots (A_I1, A_O1, S1, T_1 ... T_6), its IPP L points rotated by b and
    its IPP `a` moved by b: another transcript for each b < 8 (other y, z,
    u, x and IPP challenges), so other rows.  The rows need no valid
    proof; b = 0 is `proof`."""
    pts = [proof.A_I1, proof.A_O1, proof.S1,
           proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6]
    pts = pts[b % 8:] + pts[: b % 8]
    ipp = proof.ipp_proof
    k = b % len(ipp.L_vec)
    return bp.R1CSProof(
        *pts[:3], proof.A_I2, proof.A_O2, proof.S2, *pts[3:], proof.t_x,
        proof.t_x_blinding, proof.e_blinding,
        InnerProductProof(ipp.L_vec[k:] + ipp.L_vec[:k], ipp.R_vec,
                          ipp.a + bp.Scalar(b), ipp.b))


def summed_rows(items: list, backend, rhos: list):
    """(the VerifyRows of each (case, proof) of `items`, the host's sums g
    and h of the same proofs' host jobs weighted by `rhos`, each padded
    with zero rows to the largest padded size as ``batch_verify`` pads)."""
    rows, host = [], []
    for case, proof in items:
        host.append(case.verifier()._verification_job(proof, PC, case.gens))
        dev = case.verifier()._verification_job(proof, PC, case.gens,
                                                 backend.verify_rows)
        rows.append(dev.rows)
    N = max(j.padded_n for j in host)
    g = h = scvec.zeros(N)
    for j, rho in zip(host, rhos):
        pad = scvec.zeros(N - j.padded_n)
        g = scvec.add(g, scvec.scale(np.concatenate([j.g, pad]), rho))
        h = scvec.add(h, scvec.scale(np.concatenate([j.h, pad]), rho))
    return rows, g, h


def batch_rows(case: cs.Case, backend, B: int):
    """(the VerifyRows of B variants of the case's proof, rhos, the host's
    rho-weighted sums g and h of the same variants' host jobs); rho_0 = 1
    as ``batch_verify`` draws it, the others fixed."""
    rng = np.random.RandomState(21 + B)
    rhos = [bp.Scalar.one()] + [
        bp.Scalar.from_bytes_mod_order_wide(rng.bytes(64))
        for _ in range(B - 1)]
    rows, g, h = summed_rows([(case, variant(case.proof, b))
                              for b in range(B)], backend, rhos)
    return rows, rhos, g, h


def summed_plain(rows: list, rhos: list) -> torch.Tensor:
    """The plain version of ``gh_rows`` over `rows`' sets weighted by
    `rhos`."""
    dev = rows[0].dev
    sets = [(r.wires, r.yinv, cc.sc_powers(*vr.s_tables(*r._s, dev), r.N),
             r.n, r.n1) for r in rows]
    consts = vr.host_words([c for r, rho in zip(rows, rhos)
                            for c in r.weighted(rho)])
    return cc.gh_rows_plain(sets, consts.reshape(len(rows), 8, 8))


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("circuit", CIRCUITS)
def test_batch_rows_equal_the_host_sum(circuit, B, request):
    """``gh_rows`` over a batch's B row sets (``RowSum``, the words its
    ``msm_gens`` walks) against ``w5_words`` of the host's rho-weighted
    sum of the jobs' g and h, the plain version of the summed kernel, and
    at B = 1 the one-set words of ``VerifyRows.words`` and the one-set
    plain formula (``gh_scalars_plain``, then the w5 recode)."""
    case = request.getfixturevalue(circuit)
    rows, rhos, g, h = batch_rows(case, cpu_backend(), B)
    assert len({r.yinv[1].numpy().tobytes() for r in rows}) == B
    words = vr.VerifyRows.summed(rows, rhos, None, None).words()
    want = torch.cat([ck.w5_words(g, "cpu"), ck.w5_words(h, "cpu")])
    assert torch.equal(words, want)
    assert torch.equal(summed_plain(rows, rhos), want)
    if B == 1:
        assert torch.equal(rows[0].words(), want)
        r = rows[0]
        one = cc.gh_scalars_plain(
            r.wires, r.yinv, cc.sc_powers(*vr.s_tables(*r._s, "cpu"), r.N),
            vr._words(r._consts, "cpu"), r.n, r.n1)
        assert torch.equal(cc._w5_codes(torch.cat(one)), want)


def test_mixed_size_rows_equal_the_host_sum():
    """A batch of two padded sizes (two-phase proofs padded to 64 and to
    32): the smaller proof's rows add nothing from its own size on, and
    its h reads its own s backwards, so the summed words equal the host's
    sum of the jobs' rows padded with zeros to 64."""
    big, small = two_phase_case(40), two_phase_case(10)
    rng = np.random.RandomState(5)
    rhos = [bp.Scalar.one()] + [
        bp.Scalar.from_bytes_mod_order_wide(rng.bytes(64)) for _ in range(2)]
    rows, g, h = summed_rows([(big, big.proof), (small, small.proof),
                              (big, variant(big.proof, 1))],
                             cpu_backend(), rhos)
    assert [r.N for r in rows] == [64, 32, 64]
    words = vr.VerifyRows.summed(rows, rhos, None, None).words()
    want = torch.cat([ck.w5_words(g, "cpu"), ck.w5_words(h, "cpu")])
    assert words.shape == (128, 16)
    assert torch.equal(words, want)
    assert torch.equal(summed_plain(rows, rhos), want)


def edge_checks(dev) -> None:
    """``sc_powers`` at sizes around its run, against ``scvec.powers``;
    ``tape_flatten`` with a wire longer than ``TS_REDUCE`` terms and empty
    wires, and ``tape_sums`` with no constant terms and over more than one
    block, against the host's arrays, on `dev`."""
    base = bp.Scalar(0xC0FFEE) * bp.Scalar(2) ** 200
    for m in (1, 7, 8, 9, 63, 64, 65, 1000):
        for e0 in (0, 1):
            got = cc.sc_powers(*vr.power_tables(base, e0, m, dev), m)
            want = scvec.scale(scvec.powers(base, m), base ** e0)
            assert torch.equal(got.cpu(), _words(want)), (m, e0)
    rng = np.random.RandomState(5)
    zrows = scvec.from_wide_bytes(rng.bytes(64 * 5000))
    zp = _words(zrows).to(dev)
    counts = np.array([0, 1, 3 * cc.TS_REDUCE + 5, 0, 2])
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    T = int(counts.sum())
    cidx = rng.randint(0, 50, T).astype(np.int32)
    coeff_rows = scvec.from_wide_bytes(rng.bytes(64 * T))
    got = cc.tape_flatten(torch.from_numpy(off).to(dev),
                          torch.from_numpy(cidx).to(dev),
                          _words(coeff_rows).to(dev), zp)
    w = np.repeat(np.arange(len(counts)), counts)
    want = scvec.flatten_terms(zrows, coeff_rows, cidx.astype(np.int64), w,
                               len(counts))
    assert torch.equal(got.cpu(), _words(want))
    n, tc = 2500, cc.TS_SPAN + 3
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    for ccidx, ccoeff, wc in (
        (none, none.reshape(0, 8), bp.Scalar.zero()),
        (torch.from_numpy(cidx[:1].repeat(tc)).to(dev),
         zp[:tc].contiguous(),
         scvec.inner(zrows[:tc], scvec.zeros(tc) + zrows[cidx[0]])),
    ):
        sums = cc.tape_sums(ccidx, ccoeff, zp, zp, zp, n)
        delta = scvec.inner(scvec.mul(zrows[:n], zrows[n : 2 * n]), zrows[:n])
        assert torch.equal(sums.cpu(), _words(
            np.stack([scvec.scalar_to_row(wc), scvec.scalar_to_row(delta)])))


def test_powers_and_sums_at_edge_sizes():
    edge_checks(torch.device("cpu"))


def test_kernel_constants_match_the_source():
    """``csrc/verify_rows.cu``'s geometry and its w5 recode constant are
    the Python side's."""
    src = CSRC.read_text()
    define = dict(re.findall(r"#define (\w+) (\d+)", src))
    assert int(define["SP_RUN"]) == cc.SP_RUN
    assert int(define["VR_THREADS"]) * int(define["TS_ITEMS"]) == cc.TS_SPAN
    assert int(define["TS_REDUCE"]) == cc.TS_REDUCE
    body = re.search(r"W5C\[8\] = \{([^}]*)\}", src).group(1)
    words = [int(x, 16) for x in re.findall(r"0x([0-9a-fA-F]+)u", body)]
    assert words == list(np.ascontiguousarray(ck._W5_C).view("<u4"))


# ------------------------------------------------------------ verification
def _device_rows(spans) -> list:
    return [s.counts.get("device_rows") for s in spans if s.name == "msm_gens"]


@pytest.mark.parametrize("circuit", CIRCUITS)
def test_verify_on_device_rows_accepts_and_rejects(circuit, request,
                                                   monkeypatch):
    case = request.getfixturevalue(circuit)
    be = cpu_backend()
    spy = Spy(monkeypatch)
    metrics.take()
    metrics.enable()
    try:
        assert cs.verdict(bp, case.verifier(), case.proof, case.gens, be)
        spans = metrics.take()
        assert not cs.verdict(bp, case.verifier(),
                              cs.tampered(bp, case.proof), case.gens, be)
        assert not cs.verdict(bp, case.wrong(), case.proof, case.gens, be)
    finally:
        metrics.disable()
        metrics.take()
    N = spy.rows[0].N
    assert len(spy.rows) == 3
    assert _device_rows(spans) == [2 * N]
    verify = [s for s in spans if s.name == "verify"]
    rows = [s for s in spans if s.name == "seam.rows"]
    msm = [s for s in spans if s.name == "msm_gens"]
    assert len(verify) == len(rows) == len(msm) == 1
    assert msm[0].parent == verify[0].id and rows[0].parent == msm[0].id


def test_host_rows_where_the_device_does_not_build_them(two_phase,
                                                        monkeypatch):
    """A backend without ``verify_rows`` and the sizes ``verify_rows``
    declines run the host's rows, in a verification and in a
    ``batch_verify``."""
    spy = Spy(monkeypatch)
    case = two_phase
    metrics.take()
    metrics.enable()
    try:
        bp.batch_verify([case.verifier(), case.verifier()],
                        [case.proof, case.proof], PC, case.gens,
                        backend=bp.TorchBackend("cpu", min_device_n=1))
        for be in (NativeBackend(),
                   bp.TorchBackend("cpu", min_device_n=1),  # walks from 2049
                   # in the walker range, below min_device_n
                   bp.TorchBackend("cpu", min_device_n=1 << 20,
                                   walker_min_n=1)):
            assert getattr(be, "verify_rows", lambda *a: None)(
                None, 0, 0, 0, case.gens.gens_capacity) is None
            assert cs.verdict(bp, case.verifier(), case.proof, case.gens, be)
            assert not cs.verdict(bp, case.verifier(),
                                  cs.tampered(bp, case.proof), case.gens, be)
        spans = metrics.take()
    finally:
        metrics.disable()
        metrics.take()
    assert spy.rows == []
    assert set(_device_rows(spans)) <= {0}


@pytest.mark.parametrize("combo", ["default"])
def test_a_verify_launches_the_row_kernels_of_its_route(combo, two_phase,
                                                        monkeypatch):
    """``chip_smoke.route_kernels`` with a verify: the row kernels, in the
    walker range (the id is the reference's name of the port's route)."""
    from test_torch_backend import count_calls

    calls = count_calls(monkeypatch, cs.ROWS_KERNELS)
    assert cs.verdict(bp, two_phase.verifier(), two_phase.proof,
                      two_phase.gens, cpu_backend())
    on, off = cs.route_kernels(verify=True)
    rows = set(cs.ROWS_KERNELS)
    assert {k for k, v in calls.items() if v} == on & rows
    assert rows <= on | off
