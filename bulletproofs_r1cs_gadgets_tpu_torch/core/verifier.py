"""R1CS verifier (the ``bulletproofs::r1cs::Verifier`` equivalent).

Re-synthesizes the same constraint tape as the prover (with ``None``
assignments - the prover/verifier symmetry invariant described in SURVEY.md's
execution-model note), replays the Fiat-Shamir schedule, and checks the whole
proof with ONE combined multiscalar multiplication.

Verification equation (derivation in the module docstring of ``prover.py``;
r is a verifier-local random combining factor):

  0 == x*A_I1 + x^2*A_O1 + x^3*S1 + u*x*A_I2 + u*x^2*A_O2 + u*x^3*S2
     + sum_j (r*x^2*wV_j) * V_j
     + r*x*T_1 + r*x^3*T_3 + r*x^4*T_4 + r*x^5*T_5 + r*x^6*T_6
     + [ w*(t_x - a*b) + r*(x^2*(wc + delta) - t_x) ] * B
     + [ -e_blinding - r*t_x_blinding ] * B_blinding
     + sum_i u_g_i*(x*y^-i*wR_i - a*s_i) * G_i
     + sum_i u_g_i*(y^-i*(x*wL_i + wO_i - b*s_inv_i) - 1) * H_i
     + sum_j u_j^2 * L_j + sum_j u_j^-2 * R_j

with delta = <y^-n o wR, wL> and u_g_i = 1 for phase-1 multipliers, u for
phase-2 and padding.
"""

from __future__ import annotations

import secrets

import numpy as np

from .scalar import Scalar, exp_iter
from .linear_combination import Variable, VarKind, LinearCombination, _coerce
from .ristretto import RistrettoPoint, multiscalar_mul
from .transcript import Transcript
from .pedersen import PedersenGens, BulletproofGens
from .proof import R1CSProof, _IDENTITY
from .errors import VerificationError, InvalidGeneratorsLength, MissingAssignment
from .tape import TapeArrays
from . import scvec
from ..utils import metrics
from ..utils.stats import CircuitStats


class Verifier:
    def __init__(self, transcript: Transcript):
        self.transcript = transcript
        transcript.r1cs_domain_sep()
        self.V: list[bytes] = []  # compressed commitments
        self.num_vars = 0  # multipliers
        self.constraints: list[LinearCombination] = []
        self.pending_multiplier: int | None = None
        self.deferred_constraints = []
        self.num_phase1_multipliers = 0
        self._tape_memo: TapeArrays | None = None

    def load_compiled(self, tape: TapeArrays, num_multipliers: int) -> None:
        """Attach a template-compiled tape (:mod:`..models.compiled`)
        instead of re-synthesizing the circuit gadget-by-gadget."""
        assert self.num_vars == 0 and not self.constraints, (
            "load_compiled on a verifier with synthesized state"
        )
        self._tape_memo = tape
        self.num_vars = num_multipliers

    # ------------------------------------------------------------ commitments
    def commit(self, commitment: bytes) -> Variable:
        i = len(self.V)
        self.V.append(commitment)
        self.transcript.append_point(b"V", commitment)
        return Variable.committed(i)

    # --------------------------------------------------- ConstraintSystem API
    def multiply(self, left, right):
        left = _coerce(left)
        right = _coerce(right)
        i = self.num_vars
        self.num_vars += 1
        l_var = Variable.mult_left(i)
        r_var = Variable.mult_right(i)
        o_var = Variable.mult_out(i)
        self.constrain(left - l_var)
        self.constrain(right - r_var)
        return l_var, r_var, o_var

    def allocate(self, assignment=None):
        if self.pending_multiplier is None:
            i = self.num_vars
            self.num_vars += 1
            self.pending_multiplier = i
            return Variable.mult_left(i)
        i = self.pending_multiplier
        self.pending_multiplier = None
        return Variable.mult_right(i)

    def allocate_single(self, assignment=None):
        var = self.allocate(assignment)
        if var.kind == VarKind.MULT_RIGHT:
            return var, Variable.mult_out(var.index)
        return var, None

    def allocate_multiplier(self, assignment=None):
        i = self.num_vars
        self.num_vars += 1
        return (
            Variable.mult_left(i),
            Variable.mult_right(i),
            Variable.mult_out(i),
        )

    def constrain(self, lc) -> None:
        self.constraints.append(_coerce(lc))

    def evaluate_lc(self, lc):
        """Fork extension; verifier has no assignments -> None."""
        return None

    def specify_randomized_constraints(self, callback) -> None:
        self.deferred_constraints.append(callback)

    def num_constraints(self) -> int:
        if self._tape_memo is not None and not self.constraints:
            return self._tape_memo.num_constraints
        return len(self.constraints)

    def num_multipliers(self) -> int:
        return self.num_vars

    def stats(self) -> CircuitStats:
        return CircuitStats(
            multipliers=self.num_vars,
            constraints=len(self.constraints),
            commitments=len(self.V),
            phase1_multipliers=self.num_phase1_multipliers or self.num_vars,
        )

    # -------------------------------------------------------------- internals
    def _create_randomized_constraints(self) -> None:
        if not self.deferred_constraints:
            self.transcript.r1cs_1phase_domain_sep()
            return
        self.transcript.r1cs_2phase_domain_sep()
        callbacks = self.deferred_constraints
        self.deferred_constraints = []
        rcs = RandomizingVerifier(self)
        for cb in callbacks:
            cb(rcs)

    # ------------------------------------------------------------------ verify
    @metrics.traced("verify")
    def verify(
        self,
        proof: R1CSProof,
        pc_gens: PedersenGens,
        bp_gens: BulletproofGens,
        backend=None,
    ) -> None:
        metrics.mark("verify.scalars")
        job = self._verification_job(
            proof, pc_gens, bp_gens, getattr(backend, "verify_rows", None)
        )
        if job.rows is not None:
            # the backend's device builds g and h (ops/verify_rows.py)
            scalars_arr = job.rows.with_scalars(job)
        else:
            scalars_arr = np.concatenate(
                [
                    job.head_sc,
                    job.B_scalar_row[None, :],
                    job.B_blinding_row[None, :],
                    job.g, job.h, job.tail_sc,
                ]
            )
        head_points = job.head_points + [pc_gens.B, pc_gens.B_blinding]
        metrics.mark(None)
        mega = _run_msm(
            backend, scalars_arr, head_points, bp_gens.share(0),
            job.padded_n, job.tail_points,
        )
        if not mega.is_identity():
            raise VerificationError("R1CS proof verification failed")

    def _verification_job(
        self,
        proof: R1CSProof,
        pc_gens: PedersenGens,
        bp_gens: BulletproofGens,
        rows=None,
    ) -> "VerificationJob":
        """Replay the Fiat-Shamir schedule and reduce the proof to one
        MSM-equals-identity check, returned in segments so that
        :func:`batch_verify` can combine many proofs into a single MSM
        (the shared G/H generator segments collapse across the batch).
        With `rows` (a backend's ``verify_rows``) that builds this size's
        G/H rows on its device, the job's ``g`` and ``h`` are None and its
        ``rows`` builds them: the host replays only the IPP's challenges.

        MSM layout (scalar order == point order):
          [head: A_I1 A_O1 S1 A_I2 A_O2 S2, V_j.., T_1 T_3 T_4 T_5 T_6]
          + [B, B_blinding]  (shared basepoints, kept separate here)
          + G(padded_n) + H(padded_n)   (shared generator vectors)
          + [tail: L_j.., R_j..]        (IPP round points)
        """
        t = self.transcript
        t.append_u64(b"m", len(self.V))

        n1 = self.num_vars
        self.num_phase1_multipliers = n1
        t.validate_and_append_point(b"A_I1", proof.A_I1)
        t.validate_and_append_point(b"A_O1", proof.A_O1)
        t.validate_and_append_point(b"S1", proof.S1)

        self._create_randomized_constraints()
        n = self.num_vars
        n2 = n - n1
        padded_n = max(1, n)
        if padded_n & (padded_n - 1):
            padded_n = 1 << padded_n.bit_length()
        pad = padded_n - n
        if bp_gens.gens_capacity < padded_n:
            raise InvalidGeneratorsLength(
                f"need {padded_n} generators, have {bp_gens.gens_capacity}"
            )

        # A_I2/A_O2/S2 may be the identity (one-phase); transcript still
        # absorbs them, without the validity check.
        t.append_point(b"A_I2", proof.A_I2)
        t.append_point(b"A_O2", proof.A_O2)
        t.append_point(b"S2", proof.S2)

        y = t.challenge_scalar(b"y")
        z = t.challenge_scalar(b"z")

        tape = self._tape_memo
        if tape is None or tape.num_constraints != self.num_constraints():
            tape = TapeArrays(self.constraints)
            self._tape_memo = tape
        dev = None if rows is None else rows(
            tape, n1, n, len(self.V), padded_n
        )
        if dev is None:
            wL, wR, wO, wV, wc = tape.flatten(z, n, len(self.V), want_wc=True)
        else:
            dev.flatten(z, y.invert())

        t.validate_and_append_point(b"T_1", proof.T_1)
        t.validate_and_append_point(b"T_3", proof.T_3)
        t.validate_and_append_point(b"T_4", proof.T_4)
        t.validate_and_append_point(b"T_5", proof.T_5)
        t.validate_and_append_point(b"T_6", proof.T_6)

        u = t.challenge_scalar(b"u")
        x = t.challenge_scalar(b"x")

        t.append_scalar(b"t_x", proof.t_x)
        t.append_scalar(b"t_x_blinding", proof.t_x_blinding)
        t.append_scalar(b"e_blinding", proof.e_blinding)

        w = t.challenge_scalar(b"w")

        a = proof.ipp_proof.a
        b = proof.ipp_proof.b

        # random combining factor for the two checks
        r = Scalar.from_bytes_mod_order_wide(secrets.token_bytes(64))

        xx = x * x
        if dev is None:
            u_sq, u_inv_sq, s_arr = proof.ipp_proof.verification_scalars_arrays(
                padded_n, t
            )
            s_inv_arr = np.ascontiguousarray(s_arr[::-1])

            y_inv = y.invert()
            yinv_pow = scvec.powers(y_inv, padded_n)

            # delta = <y^-n o wR, wL>
            delta = scvec.inner(scvec.mul(yinv_pow[:n], wR), wL)

            u_g = np.concatenate(
                [
                    np.tile(scvec.scalar_to_row(Scalar.one()), (n1, 1)),
                    np.tile(scvec.scalar_to_row(u), (n2 + pad, 1)),
                ]
            )

            def _pad_wire(wv: np.ndarray) -> np.ndarray:
                if pad == 0:
                    return wv
                return np.concatenate([wv, scvec.zeros(pad)])

            # g_i = u_g_i * (x*y^-i*wR_i - a*s_i)
            g_scalars = scvec.mul(
                u_g,
                scvec.sub(
                    scvec.mul(scvec.scale(yinv_pow, x), _pad_wire(wR)),
                    scvec.scale(s_arr, a),
                ),
            )
            # h_i = u_g_i * (y^-i*(x*wL_i + wO_i - b*s_inv_i) - 1)
            ones = np.tile(scvec.scalar_to_row(Scalar.one()), (padded_n, 1))
            h_inner = scvec.sub(
                scvec.add(
                    scvec.scale(_pad_wire(wL), x), _pad_wire(wO)
                ),
                scvec.scale(s_inv_arr, b),
            )
            h_scalars = scvec.mul(u_g, scvec.sub(scvec.mul(yinv_pow, h_inner), ones))
        else:
            # the host replays only the IPP's challenges, and fetches
            # wV, wc and delta
            u_sq, u_inv_sq = dev.challenges(proof.ipp_proof, padded_n, t, x, u)
            wV, wc, delta = dev.sums()
            g_scalars = h_scalars = None

        B_scalar = w * (proof.t_x - a * b) + r * (xx * (wc + delta) - proof.t_x)
        # The reconstructed P carries e_blinding*B_blinding which the
        # (blinding-free) IPP relation must not see: subtract it here.
        B_blinding_scalar = -proof.e_blinding - r * proof.t_x_blinding

        rxx = r * xx
        head = scvec.from_scalars(
            [x, xx, xx * x, u * x, u * xx, u * xx * x]
        )
        wV_part = scvec.scale(wV, rxx) if len(self.V) else scvec.zeros(0)
        mid = scvec.from_scalars(
            [r * x, rxx * x, rxx * xx, rxx * xx * x, rxx * xx * xx]
        )
        head_sc = np.concatenate([head, wV_part, mid])

        try:
            head_points = (
                [
                    _decompress_allow_identity(proof.A_I1),
                    _decompress_allow_identity(proof.A_O1),
                    _decompress_allow_identity(proof.S1),
                    _decompress_allow_identity(proof.A_I2),
                    _decompress_allow_identity(proof.A_O2),
                    _decompress_allow_identity(proof.S2),
                ]
                + [RistrettoPoint.decompress(Vj) for Vj in self.V]
                + [
                    RistrettoPoint.decompress(proof.T_1),
                    RistrettoPoint.decompress(proof.T_3),
                    RistrettoPoint.decompress(proof.T_4),
                    RistrettoPoint.decompress(proof.T_5),
                    RistrettoPoint.decompress(proof.T_6),
                ]
            )
            tail_points = [
                RistrettoPoint.decompress(L) for L in proof.ipp_proof.L_vec
            ] + [RistrettoPoint.decompress(R) for R in proof.ipp_proof.R_vec]
        except ValueError as e:
            raise VerificationError(f"invalid point encoding: {e}")

        return VerificationJob(
            head_sc=head_sc,
            head_points=head_points,
            B_scalar_row=scvec.scalar_to_row(B_scalar),
            B_blinding_row=scvec.scalar_to_row(B_blinding_scalar),
            g=g_scalars,
            h=h_scalars,
            tail_sc=np.concatenate(
                [scvec.from_scalars(u_sq), scvec.from_scalars(u_inv_sq)]
            ),
            tail_points=tail_points,
            padded_n=padded_n,
            rows=dev,
        )


from dataclasses import dataclass


@dataclass
class VerificationJob:
    """One proof's verification equation, reduced to MSM segments
    (see :meth:`Verifier._verification_job` for the layout)."""

    head_sc: np.ndarray          # (11+m, 4) scalars for head_points
    head_points: list            # A_I1..S2, V_j.., T_1..T_6
    B_scalar_row: np.ndarray     # (4,) coefficient of pc_gens.B
    B_blinding_row: np.ndarray   # (4,) coefficient of pc_gens.B_blinding
    g: np.ndarray                # (padded_n, 4) G-vector coefficients
    h: np.ndarray                # (padded_n, 4) H-vector coefficients
    tail_sc: np.ndarray          # (2*rounds, 4) for L_j.., R_j..
    tail_points: list
    padded_n: int
    rows: object = None          # the device's G/H rows (g, h None)


def _run_msm(backend, scalars_arr, head_points, gens, padded_n, tail_points):
    if backend is not None and hasattr(backend, "msm_gens"):
        return backend.msm_gens(
            scalars_arr, head_points, gens, padded_n, tail_points
        )
    points = head_points + gens.G(padded_n) + gens.H(padded_n) + tail_points
    if backend is not None:
        return backend.msm(scalars_arr, points)
    return multiscalar_mul(scvec.to_scalars(scalars_arr), points)


@metrics.traced("batch_verify")
def batch_verify(
    verifiers: list,
    proofs: list[R1CSProof],
    pc_gens: PedersenGens,
    bp_gens: BulletproofGens,
    backend=None,
    identify_failures: bool = True,
) -> None:
    """Verify B proofs with ONE multiscalar multiplication.

    Each verification equation is an MSM that must equal the identity; a
    random linear combination sum_b rho_b * MSM_b == identity (rho_b drawn
    from the full scalar field by this verifier) accepts all-valid batches
    and rejects any invalid one except with probability ~1/L.  Because
    every proof shares the generator vectors G/H and the basepoints B/B~,
    their coefficients merge: the combined MSM has ONE G(max_padded_n) +
    H(max_padded_n) segment regardless of B — the dominant cost of
    verification collapses from B mega-MSMs to one, plus B*(13+m+2log n)
    proof-specific points.

    The dalek engine exposes the same trick for aggregated verification;
    the reference itself verifies proofs one at a time
    (gadget_bound_check.rs:89-116) — this is a framework value-add on the
    batch axis (SURVEY.md S2b N10).

    `verifiers` must be fresh Verifier instances with commitments bound
    and circuits synthesized (exactly as for `Verifier.verify`); their
    transcripts are consumed.  Raises VerificationError on failure; with
    `identify_failures` the batch is re-checked one-by-one to report the
    failing indices.
    """
    if len(verifiers) != len(proofs):
        raise ValueError("verifiers/proofs length mismatch")
    if not proofs:
        return
    metrics.count("proofs", len(proofs))
    # Each job replays one verifier's transcript and flattens its tape —
    # independent state, heavy parts in GIL-releasing C — so build them
    # on a thread pool.
    import os
    from concurrent.futures import ThreadPoolExecutor

    metrics.mark("batch_verify.jobs")
    rows = getattr(backend, "verify_rows", None)
    _workers = max(1, min((os.cpu_count() or 4) - 1, len(proofs)))
    with ThreadPoolExecutor(max_workers=_workers) as pool:
        jobs = list(
            pool.map(
                lambda vp: vp[0]._verification_job(
                    vp[1], pc_gens, bp_gens, rows
                ),
                zip(verifiers, proofs),
            )
        )
    metrics.mark("batch_verify.combine")
    rhos = [Scalar.one()] + [
        Scalar.from_bytes_mod_order_wide(secrets.token_bytes(64))
        for _ in jobs[1:]
    ]
    B_row = scvec.scale(jobs[0].B_scalar_row[None, :], rhos[0])
    Bb_row = scvec.scale(jobs[0].B_blinding_row[None, :], rhos[0])
    for j, r in zip(jobs[1:], rhos[1:]):
        B_row = scvec.add(B_row, scvec.scale(j.B_scalar_row[None, :], r))
        Bb_row = scvec.add(
            Bb_row, scvec.scale(j.B_blinding_row[None, :], r)
        )

    def _pad(arr: np.ndarray, max_pad: int) -> np.ndarray:
        if arr.shape[0] == max_pad:
            return arr
        return np.concatenate([arr, scvec.zeros(max_pad - arr.shape[0])])

    # The jobs whose G/H rows the backend's device built sum them there
    # (ops/verify_rows.py), the others on the host: each part is one MSM
    # over the shared generators, and the batch's MSM is their sum.
    msms = []
    for part in (
        [(j, r) for j, r in zip(jobs, rhos) if j.rows is None],
        [(j, r) for j, r in zip(jobs, rhos) if j.rows is not None],
    ):
        if not part:
            continue
        max_pad = max(j.padded_n for j, _ in part)
        head_sc = np.concatenate([scvec.scale(j.head_sc, r) for j, r in part])
        head_points = [p for j, _ in part for p in j.head_points]
        tail_sc = np.concatenate([scvec.scale(j.tail_sc, r) for j, r in part])
        tail_points = [p for j, _ in part for p in j.tail_points]
        if not msms:
            # the shared basepoints, once
            head_sc = np.concatenate([head_sc, B_row, Bb_row])
            head_points = head_points + [pc_gens.B, pc_gens.B_blinding]
        if part[0][0].rows is not None:
            scalars_arr = part[0][0].rows.summed(
                [j.rows for j, _ in part], [r for _, r in part],
                head_sc, tail_sc,
            )
        else:
            g = scvec.scale(_pad(part[0][0].g, max_pad), part[0][1])
            h = scvec.scale(_pad(part[0][0].h, max_pad), part[0][1])
            for j, r in part[1:]:
                g = scvec.add(g, scvec.scale(_pad(j.g, max_pad), r))
                h = scvec.add(h, scvec.scale(_pad(j.h, max_pad), r))
            scalars_arr = np.concatenate([head_sc, g, h, tail_sc])
        msms.append((scalars_arr, head_points, max_pad, tail_points))
    metrics.mark(None)
    mega = RistrettoPoint.identity()
    for scalars_arr, points, max_pad, tail_points in msms:
        mega = mega + _run_msm(
            backend, scalars_arr, points, bp_gens.share(0), max_pad,
            tail_points,
        )
    if mega.is_identity():
        return
    if not identify_failures:
        raise VerificationError(
            f"batch verification failed ({len(proofs)} proofs)"
        )
    # Re-run each equation alone to report which proofs are bad (jobs
    # already hold the reduced equations; transcripts are consumed).
    metrics.mark("batch_verify.recheck")
    bad = []
    for i, j in enumerate(jobs):
        single = _run_msm(
            backend,
            j.rows.with_scalars(j) if j.rows is not None else np.concatenate(
                [j.head_sc, j.B_scalar_row[None, :],
                 j.B_blinding_row[None, :], j.g, j.h, j.tail_sc]
            ),
            j.head_points + [pc_gens.B, pc_gens.B_blinding],
            bp_gens.share(0), j.padded_n, j.tail_points,
        )
        if not single.is_identity():
            bad.append(i)
    metrics.count("bad", len(bad))
    raise VerificationError(
        f"batch verification failed; invalid proof indices: {bad}"
    )


def _decompress_allow_identity(data: bytes) -> RistrettoPoint:
    if data == _IDENTITY:
        return RistrettoPoint.identity()
    return RistrettoPoint.decompress(data)


class RandomizingVerifier:
    def __init__(self, verifier: Verifier):
        self.verifier = verifier

    def challenge_scalar(self, label: bytes) -> Scalar:
        return self.verifier.transcript.challenge_scalar(label)

    def __getattr__(self, name):
        return getattr(self.verifier, name)
