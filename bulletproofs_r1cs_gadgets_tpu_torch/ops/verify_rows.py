"""The verifier's G/H coefficient rows, built on the backend's device.

A verification is one MSM over [head, G(N), H(N), tail] (``core/verifier.py``);
its 2N generator coefficients

  g_i = u_g_i (x y^-i wR_i - a s_i)
  h_i = u_g_i (y^-i (x wL_i + wO_i - b s_(N-1-i)) - 1)

take the host a dozen passes of mod-l arithmetic over the rows, after
flattening the constraint tape by the powers of z (``TapeArrays.flatten``),
and then a recoding and an upload of 32 B a row for the w5 walker.  Here
the card computes them from the transcript's challenges and a copy of the
tape that stays on it (:class:`DeviceTape`), and writes them straight as
the walker's words: four kernels (``ops/cuda_curve.py``, ``sc_powers``,
``tape_flatten``, ``tape_sums``, ``gh_rows``).  The host keeps the
transcript, the points and the few head scalars, for which it fetches wV,
wc and delta (one sync).  A batch verification (``batch_verify``) sums its
proofs' rows weighted by its random rho_b: ``gh_rows`` sums the B row sets
in one launch (:class:`RowSum`), each set's u_g scaled by its rho_b, a
smaller proof's rows padded with zeros to the batch's largest size.  Every
value is canonical mod l, so the rows and words equal the host path's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import scvec
from ..core.errors import VerificationError
from ..core.scalar import Scalar, batch_invert
from ..utils import metrics
from . import cuda_curve as cc
from . import field as F


def host_words(scalars) -> np.ndarray:
    """Scalars -> (k, 8) int32 canonical words on the host."""
    return scvec.from_scalars(list(scalars)).view("<i4")


def _words(scalars, device) -> torch.Tensor:
    """Scalars -> (k, 8) int32 canonical words on `device`, copied in
    stream order (the host does not wait)."""
    return F.upload_async(host_words(scalars), device)


def _run_bits(m: int) -> int:
    """The bits of the largest run index below ceil(m / SP_RUN)."""
    return max(0, -(-m // cc.SP_RUN) - 1).bit_length()


def power_tables(base: Scalar, e0: int, m: int, device):
    """``sc_powers``' tables for base^(e0 + i), i < m: hi[b] =
    base^(SP_RUN 2^b), lo[t] = base^(e0 + t)."""
    R = cc.SP_RUN
    lo = [base ** (e0 + t) for t in range(R)]
    hi, step = [], base ** R
    for _ in range(_run_bits(m)):
        hi.append(step)
        step = step * step
    return _words(hi, device), _words(lo, device)


def s_tables(u_sq: list, all_inv: Scalar, device):
    """``sc_powers``' tables for the IPP's s vector over N = 2^k rows
    (k = len(u_sq)): s_i = all_inv * prod of u_sq[k - 1 - c] over the set
    bits c of i (``InnerProductProof.verification_scalars_arrays``)."""
    k, R = len(u_sq), cc.SP_RUN
    r = R.bit_length() - 1
    lo = []
    for t in range(R):
        v = all_inv if t < 1 << k else Scalar.zero()
        for c in range(min(r, k)):
            if t >> c & 1:
                v = v * u_sq[k - 1 - c]
        lo.append(v)
    hi = [u_sq[k - 1 - (c + r)] for c in range(max(k - r, 0))]
    return _words(hi, device), _words(lo, device)


class DeviceTape:
    """A constraint tape (``core/tape.TapeArrays``) on `device`, for n
    multipliers and nv commitments.  The L, R, O and V terms sorted by
    wire (CSR over one index space: L wires [0, n), R [n, 2n), O [2n, 3n),
    V [3n, 3n + nv)): ``off`` (3n + nv + 1) offsets, ``cidx`` constraint
    indices, ``coeff`` (T, 8) coefficient words; and the constant terms
    ``ccidx`` / ``ccoeff`` (V and constant coefficients negated, as the
    tape stores them)."""

    def __init__(self, tape, n: int, nv: int, device):
        offs, cidx, coeff = [np.zeros(1, np.int64)], [], []
        for (c, w, co), size in ((tape.lc, n), (tape.rc, n), (tape.oc, n),
                                 (tape.vc, nv)):
            if len(w) and (w.min() < 0 or w.max() >= size):
                raise ValueError(f"tape wire index outside [0, {size})")
            order = np.argsort(w, kind="stable")
            offs.append(offs[-1][-1] + np.cumsum(np.bincount(w, minlength=size)))
            cidx.append(c[order])
            coeff.append(co[order])
        self.n, self.nv, self.m = n, nv, tape.num_constraints
        self.off = F.upload(np.concatenate(offs).astype(np.int32), device)
        self.cidx = F.upload(np.concatenate(cidx).astype(np.int32), device)
        self.coeff = F.upload(
            np.ascontiguousarray(np.concatenate(coeff), "<u8").view("<i4"),
            device)
        self.ccidx = F.upload(tape.onec[0].astype(np.int32), device)
        self.ccoeff = F.upload(
            np.ascontiguousarray(tape.onec[2], "<u8").view("<i4"), device)


def gh_words(rows: list, consts: list) -> torch.Tensor:
    """(2N, 16) w5 words of the sum of the G/H rows of `rows` (VerifyRows
    with their challenges replayed, N the largest padded size, a smaller
    one's rows zero from its own), row set b with the eight constants
    consts[b]: one ``gh_rows`` launch, after one ``sc_powers`` a set for
    its IPP s vector."""
    sets = [(r.wires, r.yinv, r.s_vector(), r.n, r.n1) for r in rows]
    flat = [c for cs in consts for c in cs]
    return cc.gh_rows(sets, host_words(flat).reshape(len(rows), 8, 8))


class RowSum:
    """A batch's G/H rows, which its backend's ``msm_gens`` walks as it
    walks one verification's :class:`VerifyRows`: the sum of its
    verifications' rows (VerifyRows, padded with zero rows to the largest
    padded size), verification b weighted by rho_b, which scales its u_g
    (``gh_rows``' first six constants); `head` and `tail` the batch's
    weighted head (with B and B_blinding) and tail scalars as (k, 4) u64
    rows."""

    def __init__(self, rows: list, rhos: list, head, tail):
        self.rows, self.rhos = rows, rhos
        self.head, self.tail = head, tail

    def words(self) -> torch.Tensor:
        return gh_words(self.rows, [r.weighted(rho)
                                    for r, rho in zip(self.rows, self.rhos)])


class VerifyRows:
    """One verification's G/H rows on a :class:`DeviceTape`'s device, for
    n1 phase-1 multipliers of n and padded size N.  The verifier calls
    :meth:`flatten` once it draws z (the launches overlap its replay),
    :meth:`challenges` in place of the IPP's host scalars, and
    :meth:`sums` for wV, wc and delta; it then hands :meth:`with_scalars`
    of its job to the backend's ``msm_gens`` in place of the scalar rows,
    and ``msm_gens`` walks :meth:`words`.  A batch hands :meth:`summed`
    of its verifications' rows instead."""

    def __init__(self, tape: DeviceTape, n1: int, padded_n: int):
        self.tape = tape
        self.dev = tape.off.device
        self.n1, self.n, self.N = n1, tape.n, padded_n
        self.head = self.tail = None
        self._ready = None

    def flatten(self, z: Scalar, y_inv: Scalar) -> None:
        """Launch z^1..z^m, the flatten, y^-i for i < N and the two sums,
        and the copy back of wV, wc and delta."""
        t, dev, n = self.tape, self.dev, self.n
        zp = cc.sc_powers(*power_tables(z, 1, t.m, dev), t.m)
        self.wires = cc.tape_flatten(t.off, t.cidx, t.coeff, zp)
        self.yinv = cc.sc_powers(*power_tables(y_inv, 0, self.N, dev), self.N)
        sums = cc.tape_sums(t.ccidx, t.ccoeff, zp, self.wires, self.yinv, n)
        if dev.type != "cuda":
            self._host = torch.cat([self.wires[3 * n:], sums])
            return
        with torch.cuda.device(dev):
            host = torch.empty((t.nv + 2, 8), dtype=torch.int32,
                               pin_memory=True)
            host[: t.nv].copy_(self.wires[3 * n:], non_blocking=True)
            host[t.nv:].copy_(sums, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(dev))
        self._host = host

    def sums(self):
        """(wV as (nv, 4) u64 rows, wc, delta): waits for :meth:`flatten`'s
        copy."""
        with metrics.span("seam.fetch"):
            if self._ready is not None:
                self._ready.synchronize()
            rows = self._host.numpy().copy().view("<u8")
        nv = self.tape.nv
        return (rows[:nv], scvec.row_to_scalar(rows[nv]),
                scvec.row_to_scalar(rows[nv + 1]))

    def challenges(self, ipp, n: int, transcript, x: Scalar, u: Scalar):
        """(u_sq, u_inv_sq): ``InnerProductProof.verification_scalars_arrays``'
        replay of the IPP's challenges for size `n`, without its s vector,
        which :meth:`words` builds from the squares and the inverse of the
        challenges' product; keeps them with x, the phase challenge u and
        the IPP's a and b."""
        lg_n = len(ipp.L_vec)
        if lg_n >= 32:
            raise VerificationError("inner product proof too large")
        if n != (1 << lg_n):
            raise VerificationError("n does not match proof size")
        transcript.innerproduct_domain_sep(n)
        challenges = []
        for L, R in zip(ipp.L_vec, ipp.R_vec):
            transcript.validate_and_append_point(b"L", L)
            transcript.validate_and_append_point(b"R", R)
            challenges.append(transcript.challenge_scalar(b"u"))
        challenges_inv = batch_invert(challenges)
        u_sq = [c * c for c in challenges]
        u_inv_sq = [c * c for c in challenges_inv]
        all_inv = Scalar.one()
        for ci in challenges_inv:
            all_inv = all_inv * ci
        a, b = ipp.a, ipp.b
        self._consts = [x, a, Scalar.one(), u * x, u * a, u, x, b]
        self._s = (u_sq, all_inv)
        return u_sq, u_inv_sq

    def with_scalars(self, job) -> "VerifyRows":
        """This object, holding a ``VerificationJob``'s head scalars (with
        B and B_blinding) and tail scalars as (k, 4) u64 rows."""
        self.head = np.concatenate(
            [job.head_sc, job.B_scalar_row[None, :],
             job.B_blinding_row[None, :]])
        self.tail = job.tail_sc
        return self

    def s_vector(self) -> torch.Tensor:
        """The IPP's s vector, (N, 8) on the device."""
        return cc.sc_powers(*s_tables(*self._s, self.dev), self.N)

    def words(self) -> torch.Tensor:
        """(2N, 16) w5 words: G's coefficient rows, then H's."""
        return gh_words([self], [self._consts])

    def weighted(self, rho: Scalar) -> list:
        """``gh_rows``' constants of this verification weighted by `rho`:
        g and h are linear in u_g, so rho scales u_g's three places."""
        c = self._consts
        return [rho * v for v in c[:6]] + c[6:]

    @staticmethod
    def summed(rows: list, rhos: list, head, tail) -> RowSum:
        """The rows of a batch's verifications, weighted by `rhos` and
        padded to the largest padded size, with the batch's head and tail
        scalar rows."""
        return RowSum(rows, rhos, head, tail)
