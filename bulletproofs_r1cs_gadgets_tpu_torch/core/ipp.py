"""Inner-product argument (the O(log n) folding proof).

Equivalent of the dalek bulletproofs ``inner_product_proof`` module that the
reference's engine dependency supplies (SURVEY.md S2b N7).  Transcript
schedule: ``ipp v1`` domain sep + n, then per round append L, R and draw
challenge ``u``.

The prover-side folding (2n full-width point multiplications over log n
rounds) is the hot path of proving; when a device backend is attached (see
:mod:`bulletproofs_r1cs_gadgets_tpu.ops.msm`) the vector folds and L/R MSMs
run batched on TPU and only the 64-byte transcript interaction stays on host.
"""

from __future__ import annotations

from .scalar import Scalar, inner_product, batch_invert
from .ristretto import RistrettoPoint, multiscalar_mul
from .transcript import Transcript
from .errors import VerificationError, FormatError


class InnerProductProof:
    __slots__ = ("L_vec", "R_vec", "a", "b")

    def __init__(self, L_vec: list[bytes], R_vec: list[bytes], a: Scalar, b: Scalar):
        self.L_vec = L_vec  # compressed points
        self.R_vec = R_vec
        self.a = a
        self.b = b

    # ------------------------------------------------------------------ create
    @staticmethod
    def create(
        transcript: Transcript,
        Q: RistrettoPoint,
        G_factors: list[Scalar],
        H_factors: list[Scalar],
        G: list[RistrettoPoint],
        H: list[RistrettoPoint],
        a: list[Scalar],
        b: list[Scalar],
        backend=None,
    ) -> "InnerProductProof":
        n = len(G)
        assert n == len(H) == len(a) == len(b) == len(G_factors) == len(H_factors)
        assert n == 0 or (n & (n - 1)) == 0, "n must be a power of two"
        transcript.innerproduct_domain_sep(n)

        if backend is not None:
            return backend.ipp_create(
                transcript, Q, G_factors, H_factors, G, H, a, b
            )

        L_vec: list[bytes] = []
        R_vec: list[bytes] = []
        first = True
        G = list(G)
        H = list(H)
        a = list(a)
        b = list(b)
        while n != 1:
            n //= 2
            a_L, a_R = a[:n], a[n:]
            b_L, b_R = b[:n], b[n:]
            G_L, G_R = G[:n], G[n:]
            H_L, H_R = H[:n], H[n:]
            c_L = inner_product(a_L, b_R)
            c_R = inner_product(a_R, b_L)
            if first:
                # fold the G/H factors of the *outer* protocol into round 1
                L = multiscalar_mul(
                    [ai * G_factors[n + i] for i, ai in enumerate(a_L)]
                    + [bi * H_factors[i] for i, bi in enumerate(b_R)]
                    + [c_L],
                    G_R + H_L + [Q],
                )
                R = multiscalar_mul(
                    [ai * G_factors[i] for i, ai in enumerate(a_R)]
                    + [bi * H_factors[n + i] for i, bi in enumerate(b_L)]
                    + [c_R],
                    G_L + H_R + [Q],
                )
            else:
                L = multiscalar_mul(a_L + b_R + [c_L], G_R + H_L + [Q])
                R = multiscalar_mul(a_R + b_L + [c_R], G_L + H_R + [Q])
            L_c = L.compress()
            R_c = R.compress()
            L_vec.append(L_c)
            R_vec.append(R_c)
            transcript.append_point(b"L", L_c)
            transcript.append_point(b"R", R_c)
            u = transcript.challenge_scalar(b"u")
            u_inv = u.invert()
            a = [a_L[i] * u + u_inv * a_R[i] for i in range(n)]
            b = [b_L[i] * u_inv + u * b_R[i] for i in range(n)]
            if first:
                G = [
                    multiscalar_mul(
                        [u_inv * G_factors[i], u * G_factors[n + i]],
                        [G_L[i], G_R[i]],
                    )
                    for i in range(n)
                ]
                H = [
                    multiscalar_mul(
                        [u * H_factors[i], u_inv * H_factors[n + i]],
                        [H_L[i], H_R[i]],
                    )
                    for i in range(n)
                ]
                first = False
            else:
                G = [
                    multiscalar_mul([u_inv, u], [G_L[i], G_R[i]]) for i in range(n)
                ]
                H = [
                    multiscalar_mul([u, u_inv], [H_L[i], H_R[i]]) for i in range(n)
                ]
        return InnerProductProof(L_vec, R_vec, a[0], b[0])

    # ------------------------------------------------- verification scalars
    def verification_scalars(
        self, n: int, transcript: Transcript
    ) -> tuple[list[Scalar], list[Scalar], list[Scalar]]:
        """Replay challenges; return (u^2 vec, u^-2 vec, s vec)."""
        u_sq, u_inv_sq, s_arr = self.verification_scalars_arrays(n, transcript)
        from . import scvec

        return u_sq, u_inv_sq, scvec.to_scalars(s_arr)

    def verification_scalars_arrays(self, n: int, transcript: Transcript):
        """Like :meth:`verification_scalars` but returns the length-n ``s``
        vector as a (n, 4) u64 array built with log n vector scalings
        (s_i = prod_j u_j^{+-1} by the bits of i — each doubling of the
        prefix is one scaling of the existing prefix)."""
        from . import scvec
        import numpy as np

        lg_n = len(self.L_vec)
        if lg_n >= 32:
            raise VerificationError("inner product proof too large")
        if n != (1 << lg_n):
            raise VerificationError("n does not match proof size")
        transcript.innerproduct_domain_sep(n)

        challenges = []
        for L, R in zip(self.L_vec, self.R_vec):
            transcript.validate_and_append_point(b"L", L)
            transcript.validate_and_append_point(b"R", R)
            challenges.append(transcript.challenge_scalar(b"u"))

        challenges_inv = batch_invert(challenges)
        u_sq = [u * u for u in challenges]
        u_inv_sq = [u * u for u in challenges_inv]

        all_inv = Scalar.one()
        for ui in challenges_inv:
            all_inv = all_inv * ui

        s = scvec.from_scalars([all_inv])
        for j in range(lg_n):
            # entries [2^j, 2^(j+1)) = entries [0, 2^j) * u_sq[lg_n-1-j]
            s = np.concatenate([s, scvec.scale(s, u_sq[lg_n - 1 - j])])
        return u_sq, u_inv_sq, s

    # --------------------------------------------------------------- codec
    def to_bytes(self) -> bytes:
        out = bytearray()
        for L, R in zip(self.L_vec, self.R_vec):
            out += L
            out += R
        out += self.a.to_bytes()
        out += self.b.to_bytes()
        return bytes(out)

    @staticmethod
    def from_bytes(data: bytes) -> "InnerProductProof":
        if len(data) % 32 != 0 or len(data) < 64:
            raise FormatError("bad inner product proof length")
        num_elems = len(data) // 32
        lg_n = (num_elems - 2) // 2
        if 2 * lg_n + 2 != num_elems or lg_n >= 32:
            raise FormatError("bad inner product proof shape")
        L_vec, R_vec = [], []
        for i in range(lg_n):
            L_vec.append(data[64 * i : 64 * i + 32])
            R_vec.append(data[64 * i + 32 : 64 * i + 64])
        a = _canonical_scalar(data[-64:-32])
        b = _canonical_scalar(data[-32:])
        return InnerProductProof(L_vec, R_vec, a, b)


class _SkipDomainSep:
    """Transcript wrapper: skips exactly one ``innerproduct_domain_sep``
    (used when the caller has already appended it before delegating to the
    list-based :meth:`InnerProductProof.create`)."""

    def __init__(self, inner):
        self._inner = inner
        self._skipped = False

    def innerproduct_domain_sep(self, n):
        if self._skipped:
            self._inner.innerproduct_domain_sep(n)
        self._skipped = True

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _skip_domain_sep(transcript) -> _SkipDomainSep:
    return _SkipDomainSep(transcript)


def _canonical_scalar(b: bytes) -> Scalar:
    from ..utils.constants import L as ORDER

    v = int.from_bytes(b, "little")
    if v >= ORDER:
        raise FormatError("non-canonical scalar in proof")
    return Scalar(v)
