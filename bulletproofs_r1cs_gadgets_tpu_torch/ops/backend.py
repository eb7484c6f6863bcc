"""The device-oracle backend of the proof engine (the JAX package's
``ops/backend.py``, which its ``ops/pallas_backend.py:16`` calls "the
XLA-composed variant (the CPU-testable oracle)").

The Prover/Verifier/IPP accept a ``backend`` whose methods route the
MSM-heavy steps to the device.  :class:`DeviceBackend` keeps the
reference's straightforward flow and runs it on the device-oracle
kernels:

* every MSM (the phase-1 commitments, each IPP round's L and R, the
  verifier's mega-MSM) is :func:`.msm.msm_device`: ``msm_chunk_acc``
  calls chained through the accumulator;
* the IPP's generator folds are ``fold_grid`` launches
  (:func:`fold_points` with the round's constants u^-1 and u, one word row
  for every lane; :func:`_fold_with_scalars` in round 1, where the outer
  G / H factors make one scalar per lane);
* only the 64-byte transcript exchange (append L, R; draw u) returns to
  the host, once per round.

The scalar side (the a / b folds, the round-1 products with the factor
vectors, the inner products) is host arithmetic on ``core/scvec``'s
``(n, 4)`` u64 rows (``mul``, ``scale``, ``axpby``, ``inner``), which give
the values the reference computes with Python loops over ``Scalar``
lists; the fold words come from ``ck.signed_digit2_words`` on those rows.
Circuits whose padded size is below ``min_device_n`` (the reference's
host/device crossover, ``utils/config.py``) take the host path, and so do
MSMs of fewer points.  Proof bytes equal the host path's and
``TorchBackend``'s: every L and R is the same group element.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import scvec
from ..core.ipp import InnerProductProof, _skip_domain_sep
from ..core.ristretto import RistrettoPoint, multiscalar_mul
from ..utils.config import DEFAULT_CONFIG
from . import chunks as ck
from . import cuda_curve as cc
from . import field as F
from .curve import points_from_device, points_to_device
from .msm import MsmEngine, msm_device, scalar_rows

MIN_DEVICE_N = DEFAULT_CONFIG.engine.min_device_n


def _row(s) -> np.ndarray:
    return scvec.scalar_to_row(s)[None]


def fold_points(points: torch.Tensor, u_inv, u) -> torch.Tensor:
    """Joint fold of a generator vector (2v, 4, 8) by two constants:
    u_inv * left + u * right, left = points[:v], right = points[v:2v].
    One ``fold_grid`` launch, each constant one w2 word row for every
    lane (the reference's ``fold_points`` scans the constants' bits)."""
    v = points.shape[0] // 2
    dev = points.device
    return cc.fold_grid(points, ck.const_grid_words(u_inv, dev),
                        ck.const_grid_words(u, dev), v)


def _fold_with_scalars(points: torch.Tensor, s_left: np.ndarray,
                       s_right: np.ndarray) -> torch.Tensor:
    """Per-element fold s_left_i * left_i + s_right_i * right_i with
    distinct scalars (round 1 folds the outer G / H factors in): one
    ``fold_grid`` launch with w2 words per lane."""
    v = points.shape[0] // 2
    dev = points.device
    return cc.fold_grid(points, ck.w2_words(s_left, dev),
                        ck.w2_words(s_right, dev), v)


class DeviceBackend:
    """Routes the engine's heavy vector math to the device-oracle kernels
    on `device`: the card by default, where every wrapper launches its
    kernel.  Only ``device="cpu"`` runs the kernels' plain versions on the
    host (as the CPU tests do); without a CUDA device the default refuses
    to construct."""

    def __init__(self, device="cuda", min_device_n: int = MIN_DEVICE_N):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceBackend: no CUDA device; pass device='cpu' to run "
                    "the kernels' plain versions on the host"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.engine = MsmEngine(self.device)
        self.min_device_n = min_device_n
        self._gens_cache: dict = {}

    # ------------------------------------------------------------- helpers
    def _gens_device(self, gens_share, n: int, which: str) -> torch.Tensor:
        key = (id(gens_share._gens), which)
        cached = self._gens_cache.get(key)
        if cached is None or cached.shape[0] < n:
            raw = gens_share.G_raw(n) if which == "G" else gens_share.H_raw(n)
            cached = F.from_raw(raw, self.device)
            self._gens_cache[key] = cached
        return cached[:n]

    def _msm_dev(self, scalars, dev: torch.Tensor) -> torch.Tensor:
        """Device MSM hook (the reference's sharded backend overrides it)."""
        return msm_device(scalars, dev)

    def msm(self, scalars, points: list[RistrettoPoint]) -> RistrettoPoint:
        rows = scalar_rows(scalars)
        if len(rows) < self.min_device_n:
            return multiscalar_mul(scvec.to_scalars(rows), points)
        return points_from_device(
            self._msm_dev(rows, points_to_device(points, self.device))
        )[0]

    # ------------------------------------------------------ batched variants
    def phase_commitments_batch(self, jobs: list[tuple]) -> list[tuple]:
        return [self.phase_commitments(*job) for job in jobs]

    def ipp_create_batch(self, jobs: list[tuple]) -> list:
        return [self.ipp_create(*job) for job in jobs]

    def msm_gens(
        self, scalars, head_points, gens_share, padded_n, tail_points
    ) -> RistrettoPoint:
        """Verifier mega-MSM over [head, G(padded_n), H(padded_n), tail],
        the generators read from the device cache."""
        rows = scalar_rows(scalars)
        nh, nt = len(head_points), len(tail_points)
        if nh + 2 * padded_n + nt < self.min_device_n:
            pts = (head_points + gens_share.G(padded_n)
                   + gens_share.H(padded_n) + tail_points)
            return multiscalar_mul(scvec.to_scalars(rows), pts)
        dev = torch.cat([
            points_to_device(head_points, self.device),
            self._gens_device(gens_share, padded_n, "G"),
            self._gens_device(gens_share, padded_n, "H"),
            points_to_device(tail_points, self.device),
        ])
        return points_from_device(self._msm_dev(rows, dev))[0]

    # -------------------------------------------------- prover commitments
    def phase_commitments(
        self, gens_share, a_L, a_R, a_O, s_L, s_R,
        i_blinding, o_blinding, s_blinding, B_blinding, offset,
    ):
        a_L, a_R, a_O, s_L, s_R = (scalar_rows(x) for x in
                                   (a_L, a_R, a_O, s_L, s_R))
        n = len(a_L)
        if n < self.min_device_n:
            G = gens_share.G(offset + n)[offset:]
            H = gens_share.H(offset + n)[offset:]
            sc = scvec.to_scalars
            A_I = multiscalar_mul(
                [i_blinding] + sc(a_L) + sc(a_R), [B_blinding] + G + H
            ).compress()
            A_O = multiscalar_mul(
                [o_blinding] + sc(a_O), [B_blinding] + G
            ).compress()
            S = multiscalar_mul(
                [s_blinding] + sc(s_L) + sc(s_R), [B_blinding] + G + H
            ).compress()
            return A_I, A_O, S

        G_dev = self._gens_device(gens_share, offset + n, "G")[offset:]
        H_dev = self._gens_device(gens_share, offset + n, "H")[offset:]
        B_dev = points_to_device([B_blinding], self.device)
        GH = torch.cat([B_dev, G_dev, H_dev])
        A_I = self._msm_dev(np.concatenate([_row(i_blinding), a_L, a_R]), GH)
        A_O = self._msm_dev(np.concatenate([_row(o_blinding), a_O]),
                            torch.cat([B_dev, G_dev]))
        S = self._msm_dev(np.concatenate([_row(s_blinding), s_L, s_R]), GH)
        pts = points_from_device(torch.stack([A_I, A_O, S]))
        return pts[0].compress(), pts[1].compress(), pts[2].compress()

    # ------------------------------------------------------------------ IPP
    def ipp_create(
        self, transcript, Q, G_factors, H_factors, gens_share, padded_n,
        a, b, meta=None,
    ) -> InnerProductProof:
        # `meta` (the factor vectors' structure) serves only the grid
        # backends; this oracle folds the factors in explicitly.
        G_factors, H_factors, a, b = (scalar_rows(x) for x in
                                      (G_factors, H_factors, a, b))
        n = padded_n
        if n < self.min_device_n:
            sc = scvec.to_scalars
            return InnerProductProof.create(
                _skip_domain_sep(transcript), Q, sc(G_factors), sc(H_factors),
                gens_share.G(n), gens_share.H(n), sc(a), sc(b),
            )

        G_dev = self._gens_device(gens_share, n, "G")
        H_dev = self._gens_device(gens_share, n, "H")
        Q_dev = points_to_device([Q], self.device)
        L_vec: list[bytes] = []
        R_vec: list[bytes] = []
        first = True
        while n != 1:
            n //= 2
            a_L, a_R = a[:n], a[n:]
            b_L, b_R = b[:n], b[n:]
            c_L = scvec.inner(a_L, b_R)
            c_R = scvec.inner(a_R, b_L)
            if first:
                sc_L = np.concatenate([
                    scvec.mul(a_L, G_factors[n : 2 * n]),
                    scvec.mul(b_R, H_factors[:n]), _row(c_L),
                ])
                sc_R = np.concatenate([
                    scvec.mul(a_R, G_factors[:n]),
                    scvec.mul(b_L, H_factors[n : 2 * n]), _row(c_R),
                ])
            else:
                sc_L = np.concatenate([a_L, b_R, _row(c_L)])
                sc_R = np.concatenate([a_R, b_L, _row(c_R)])
            pts_L = torch.cat([G_dev[n:], H_dev[:n], Q_dev])
            pts_R = torch.cat([G_dev[:n], H_dev[n:], Q_dev])
            L_pt = self._msm_dev(sc_L, pts_L)
            R_pt = self._msm_dev(sc_R, pts_R)
            L_c, R_c = (p.compress() for p in
                        points_from_device(torch.stack([L_pt, R_pt])))
            L_vec.append(L_c)
            R_vec.append(R_c)
            transcript.append_point(b"L", L_c)
            transcript.append_point(b"R", R_c)
            u = transcript.challenge_scalar(b"u")
            u_inv = u.invert()
            a = scvec.axpby(a_L, u, a_R, u_inv)
            b = scvec.axpby(b_L, u_inv, b_R, u)
            if first:
                # fold the outer G / H factors in: G'_i = (u^-1 gf_i) G_L +
                # (u gf_{n+i}) G_R, H'_i = (u hf_i) H_L + (u^-1 hf_{n+i}) H_R
                G_dev = _fold_with_scalars(
                    G_dev, scvec.scale(G_factors[:n], u_inv),
                    scvec.scale(G_factors[n : 2 * n], u),
                )
                H_dev = _fold_with_scalars(
                    H_dev, scvec.scale(H_factors[:n], u),
                    scvec.scale(H_factors[n : 2 * n], u_inv),
                )
                first = False
            else:
                G_dev = fold_points(G_dev, u_inv, u)
                H_dev = fold_points(H_dev, u, u_inv)
        return InnerProductProof(
            L_vec, R_vec, scvec.row_to_scalar(a[0]), scvec.row_to_scalar(b[0])
        )
