"""Prover/verifier device backend on the port's kernels.

The engine (``core/prover.py``, ``core/verifier.py``) reaches the device
through a narrow seam: ``phase_commitments`` / ``ipp_create`` for the
prover and ``msm_gens`` / ``msm`` for the verifier.  :class:`TorchBackend`
implements that seam on the port's kernels, following the JAX package's
``PallasBackend`` under its default flags.  It has one route, and size
alone picks each branch of it.

The grid branches serve sizes in the reference's grid range
(``walker_min_n`` .. ``WALKER_MAX_N``: more than one 2048-point chunk, at
most 128 of them), and their rounds run while the side n >= COMB_MIN_N
(the reference's CHUNK):

* every walk over the SHARED generators (the phase-1 commitments, IPP
  round 1 and the verifier's G/H segments) runs the w5 walker
  ``msm_win5`` over ``table_w5`` tables built once per generator set;
* after round 1, with at least 2 * COMB_MIN_N points per side left, the
  IPP moves to the combined layout: ``fold_w3h`` folds G and H into the
  two halves of one tensor C = [G' | H'] and ``table_w4`` builds its
  8-entry table; each round while n >= COMB_MIN_N is one
  ``msm_win_pair`` launch (L and R) and one ``fold_w3h_comb`` launch,
  with the table rebuilt in its old storage while n >= 2 * COMB_MIN_N
  (pallas_backend.py:841-857, :1027-1068);
* with fewer points left (padded n = 4096), round 1 folds each side with
  ``fold_c`` (pallas_backend.py:1069-1076);
* the rounds below COMB_MIN_N (and every round 2+ off the grid range)
  run the chunk-list route: ``msm_w4`` per side and ``fold_bits`` folds,
  then ``msm_w4_pair`` once frozen;
* in a batch whose active jobs are all frozen, one ``msm_lane`` launch
  computes every job's L and R (the flotilla);
* every other MSM is one ``msm_w4`` launch.

A verification in the grid range gets its G/H coefficient rows from the
card (:meth:`TorchBackend.verify_rows`, ``ops/verify_rows.py``:
``sc_powers``, ``tape_flatten``, ``tape_sums`` and ``gh_rows`` from a
device copy of the constraint tape), and ``msm_gens`` walks the words
``gh_rows`` writes; in a ``batch_verify`` each proof gets its rows so,
and one ``gh_rows`` launch sums them, rho-weighted and padded to the
largest size, into the words its ``msm_gens`` walks.  At other sizes the
verifier builds the rows on the host; a batch whose proofs take both
paths sums each part where its rows are, in an MSM of its own.

The reference's other route flags (``BPTPU_*``, pallas_backend.py:61-98)
pick kernels that lose to these on the card, and the port reads none of
them.  Their kernels (``msm_win``, ``msm_grid``, ``fold_c_comb``) stay
in ``cuda_curve``, each held to its plain version.

The half-width folds split each fold constant c as alpha / beta
(``ck.half_gcd_split``) and fold by beta * L + alpha * R; beta^-1 goes
into the host factor vectors, whose two pieces then differ by the ratio
beta_A / beta_B (the full bookkeeping of pallas_backend.py:964-1004).

Proof bytes do not depend on which kernels compute a point: every
commitment and every L/R point is the same group element as the host
engine's, and ristretto compression is canonical.  The host-side Q terms
and blinding heads, the factor-vector bookkeeping, the frozen-tail
helpers and the batch scheduler are the JAX package's
(``ops/pallas_backend.py`` :317-532, :540-654, :657-1103), re-homed here
because that module imports JAX.

Scalar vectors arrive as ``(n, 4) uint64`` numpy arrays (``core/scvec``);
points live on the device as flat ``(n, 4, 8)`` int32 tensors (one launch
per MSM or fold, whatever n).
"""

from __future__ import annotations

import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..core import scvec
from ..core.ipp import (
    InnerProductProof,
    _skip_domain_sep,
)
from ..core.ristretto import (
    RistrettoPoint,
    multiscalar_mul,
)
from ..core.scalar import Scalar
from ..utils import metrics
from ..utils.config import DEFAULT_CONFIG
from ..utils.constants import L as _L

from . import build
from . import chunks as ck
from . import cuda_curve as cc
from . import field as F
from . import verify_rows as vr

MIN_DEVICE_N = DEFAULT_CONFIG.engine.pallas_min_device_n
# Frozen-tail side cap (see the frozen-tail helpers below).
FROZEN_MAX_SIDE = 1024
# The reference's grid range: the shared-table walker serves n points when
# they span 2..GRID_CHUNKS chunks of CHUNK points (``_nchunks`` and
# ``_gens_big`` / ``_gens_table``, pallas_backend.py:118, :161-193).
CHUNK = 2048
GRID_CHUNKS = 128
WALKER_MIN_N = CHUNK + 1
WALKER_MAX_N = GRID_CHUNKS * CHUNK
# The combined layout's threshold (the reference's CHUNK): IPP rounds of
# side n >= COMB_MIN_N run combined after a walker round 1 of side
# >= 2 * COMB_MIN_N.  Read at call time and by nothing else, so tests
# lower it to reach the combined rounds at small sizes, and raising it
# above the padded size turns the combined route off.
COMB_MIN_N = CHUNK
# A flotilla round walks 2 segments per job, at most GRID_CHUNKS of them
# (pallas_backend.py:474).
FLOTILLA_MAX_SEGMENTS = GRID_CHUNKS
# Device copies of constraint tapes kept for the verifier's rows (the
# newest; a tape of 2^18 multipliers holds about 25 MB).
TAPE_CACHE = 2


@dataclass(frozen=True)
class Route:
    """No fields: the backend has one route.  Kept so that callers which
    pass ``TorchBackend(route=Route())`` keep working."""


def _as_array(scalars) -> np.ndarray:
    """list[Scalar] | (n,4) u64 array -> (n,4) u64 array."""
    if isinstance(scalars, np.ndarray):
        return scalars
    return scvec.from_scalars(list(scalars))


class TorchBackend:
    """Routes the engine's heavy vector math to the port's kernels on
    `device`: the card by default, where every wrapper launches its
    kernel.  Only a caller that asks for ``device="cpu"`` gets the
    kernels' plain torch versions on the host (as the CPU tests do);
    without a CUDA device the default refuses to construct.

    ``frozen_max_side`` is the IPP's frozen-tail side cap; lowering it (to
    0 to disable freezing) lets small CPU tests walk the unfrozen rounds.
    ``walker_min_n`` is the smallest walk over the shared generators that
    takes a grid branch (the reference's: more than one 2048-point chunk;
    up to ``WALKER_MAX_N``); lowering it lets small CPU tests reach the
    grid branches.  ``route`` is accepted and ignored (:class:`Route`).
    Proof bytes depend on none of these."""

    def __init__(self, device="cuda", min_device_n: int = MIN_DEVICE_N,
                 frozen_max_side: int = FROZEN_MAX_SIDE,
                 walker_min_n: int = WALKER_MIN_N,
                 route: Route | None = None):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend: no CUDA device; pass device='cpu' to run "
                    "the kernels' plain versions on the host"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.min_device_n = min_device_n
        self.frozen_max_side = frozen_max_side
        self.walker_min_n = walker_min_n
        self._gens_cache: dict = {}
        self._point_cache: dict = {}
        self._tapes: dict = {}
        self._tapes_lock = threading.Lock()

    def evict_gens(self) -> None:
        """Free every cached generator tensor and shared table (the cache is
        keyed by ``id(gens_share._gens)``, so dead gens objects can never
        be hit again yet still pin device memory: 1 GiB of tables at
        2^18), and the device tapes."""
        self._gens_cache.clear()
        self._point_cache.clear()
        with self._tapes_lock:
            self._tapes.clear()

    # -------------------------------------------------- generator caching
    def _gens(self, gens_share, n: int, which: str) -> torch.Tensor:
        """(n, 4, 8) device tensor of generator points (cached per gens
        object; a larger cached tensor serves smaller n)."""
        key = (id(gens_share._gens), which)
        got = self._gens_cache.get(key)
        if got is None or got.shape[0] < n:
            raw = gens_share.G_raw(n) if which == "G" else gens_share.H_raw(n)
            got = F.from_raw(raw, self.device)
            self._gens_cache[key] = got
        return got[:n]

    def _gens_table(self, gens_share, n: int, which: str) -> torch.Tensor:
        """Shared ``table_w5`` table of the first >= n generators, built
        once per gens object (``PallasBackend._gens_table``).  It covers n
        rounded up to a power of two (at most the capacity), so the
        phase-1 walk over the multipliers and the IPP's round 1 over the
        padded size share one build."""
        key = (id(gens_share._gens), which, "tbl5")
        got = self._gens_cache.get(key)
        if got is None or got.shape[0] < n:
            cap = gens_share._gens.gens_capacity
            m = max(n, min(1 << (n - 1).bit_length(), cap))
            got = cc.table_w5(self._gens(gens_share, m, which))
            self._gens_cache[key] = got
        return got

    def verify_rows(self, tape, n1: int, n: int, nv: int, padded_n: int):
        """The verifier's G/H rows for a proof of padded size `padded_n`
        over `tape` (n1 phase-1 multipliers of n, nv commitments), built on
        this backend's device: a :class:`verify_rows.VerifyRows` that
        ``msm_gens`` takes in place of the scalar rows.  None where the
        rows would walk no w5 table (a size outside the walker range, or
        below ``min_device_n``): those keep the host's rows.  The
        device copy of a tape is made at its first verification and kept
        (the newest ``TAPE_CACHE``, keyed by the tape object, which the
        cache holds)."""
        if not (self.walks(padded_n) and 2 * padded_n >= self.min_device_n):
            return None
        key = (id(tape), n, nv)
        with self._tapes_lock:
            got = self._tapes.pop(key, None)
            if got is None:
                got = (tape, vr.DeviceTape(tape, n, nv, self.device))
            self._tapes[key] = got
            while len(self._tapes) > TAPE_CACHE:
                del self._tapes[next(iter(self._tapes))]
        return vr.VerifyRows(got[1], n1, padded_n)

    def walks(self, n: int) -> bool:
        """Whether a walk over n shared generators takes the w5 walker (the
        reference's capacity arrays, ``_gens_big``)."""
        return self.walker_min_n <= n <= WALKER_MAX_N

    def _shared_msm(self, gens_share, n, which, arr, chain=None):
        """chain (default: the identity) + <arr, first n generators of
        `which`>: one ``msm_win5`` walk over the shared table."""
        table = self._gens_table(gens_share, n, which)
        with metrics.span("seam.encode"):
            words = ck.w5_words(arr, self.device)
        with metrics.span("seam.launch"):
            if chain is None:
                chain = F.identity_points(1, self.device)
            return cc.msm_win5(table, words, chain, n)

    def _cached_point(self, tag: str, point: RistrettoPoint) -> torch.Tensor:
        key = (tag, point.compress())
        got = self._point_cache.get(key)
        if got is None:
            got = F.from_points([point], self.device)
            self._point_cache[key] = got
        return got

    # ------------------------------------------------------------- MSM API
    def msm(self, scalars, points: list[RistrettoPoint]) -> RistrettoPoint:
        if len(scalars) < self.min_device_n:
            if isinstance(scalars, np.ndarray):
                scalars = scvec.to_scalars(scalars)
            return multiscalar_mul(scalars, points)
        arr = _as_array(scalars)
        acc = ck.msm_chain(
            F.from_points(points, self.device),
            ck.w4_words(arr, self.device),
        )
        return ck.fetch_points([acc])[0]

    @metrics.traced("msm_gens")
    def msm_gens(
        self, scalars, head_points, gens_share, padded_n, tail_points
    ) -> RistrettoPoint:
        """Verifier mega-MSM over [head, G(padded_n), H(padded_n), tail]:
        in the grid range the chain head ``msm_w4`` -> G -> H -> tail
        ``msm_w4``, G and H each a walk over the shared table
        (pallas_backend.py:235-261);
        otherwise one ``msm_w4`` launch.  A span ``msm_gens``, its
        children ``seam.encode`` / ``seam.launch`` / ``seam.fetch``.
        `scalars` may be device rows instead (:meth:`_msm_gens_rows`): one
        verification's :meth:`verify_rows`, or a batch's sum of them
        (``verify_rows.RowSum``); the span counts the rows built on the
        device, ``device_rows``."""
        if isinstance(scalars, (vr.VerifyRows, vr.RowSum)):
            return self._msm_gens_rows(scalars, head_points, gens_share,
                                       padded_n, tail_points)
        metrics.count("device_rows", 0)
        nh, nt = len(head_points), len(tail_points)
        total = nh + 2 * padded_n + nt
        arr = _as_array(scalars)
        if total < self.min_device_n:
            pts = (
                head_points + gens_share.G(padded_n)
                + gens_share.H(padded_n) + tail_points
            )
            return multiscalar_mul(scvec.to_scalars(arr), pts)
        dev = self.device
        if self.walks(padded_n):
            with metrics.span("seam.encode"):
                head = F.from_points(head_points, dev)
                words = ck.w4_words(arr[:nh], dev)
            with metrics.span("seam.launch"):
                acc = ck.msm_chain(head, words)
            g_end, h_end = nh + padded_n, nh + 2 * padded_n
            acc = self._shared_msm(gens_share, padded_n, "G", arr[nh:g_end],
                                   acc)
            acc = self._shared_msm(gens_share, padded_n, "H",
                                   arr[g_end:h_end], acc)
            with metrics.span("seam.encode"):
                tail = F.from_points(tail_points, dev)
                words = ck.w4_words(arr[h_end:], dev)
            with metrics.span("seam.launch"):
                acc = ck.msm_chain(tail, words, acc)
        else:
            with metrics.span("seam.encode"):
                pts = torch.cat([
                    F.from_points(head_points, dev),
                    self._gens(gens_share, padded_n, "G"),
                    self._gens(gens_share, padded_n, "H"),
                    F.from_points(tail_points, dev),
                ])
                words = ck.w4_words(arr, dev)
            with metrics.span("seam.launch"):
                acc = ck.msm_chain(pts, words)
        with metrics.span("seam.fetch"):
            return ck.fetch_points([acc])[0]

    def _msm_gens_rows(self, rows, head_points, gens_share, padded_n,
                       tail_points) -> RistrettoPoint:
        """``msm_gens`` over device rows: ``gh_rows`` writes the G and H
        walks' w5 words on the device (span ``seam.rows``), the head and
        tail scalars are encoded on the host meanwhile, then the chain
        head ``msm_w4`` -> G -> H -> tail ``msm_w4``."""
        dev, N = self.device, padded_n
        metrics.count("device_rows", 2 * N)
        tables = [self._gens_table(gens_share, N, w) for w in "GH"]
        with metrics.span("seam.rows"):
            words = rows.words()
        with metrics.span("seam.encode"):
            head = F.from_points(head_points, dev)
            head_words = ck.w4_words(rows.head, dev)
            tail = F.from_points(tail_points, dev)
            tail_words = ck.w4_words(rows.tail, dev)
        with metrics.span("seam.launch"):
            acc = ck.msm_chain(head, head_words)
            acc = cc.msm_win5(tables[0], words, acc, N)
            acc = cc.msm_win5(tables[1], words, acc, N, woff=N)
            acc = ck.msm_chain(tail, tail_words, acc)
        with metrics.span("seam.fetch"):
            return ck.fetch_points([acc])[0]

    # -------------------------------------------------- prover commitments
    def _phase_host(
        self, gens_share, a_L, a_R, a_O, s_L, s_R,
        i_blinding, o_blinding, s_blinding, B_blinding, offset,
    ):
        n = len(a_L)
        G = gens_share.G(offset + n)[offset:]
        H = gens_share.H(offset + n)[offset:]
        a_Ls, a_Rs, a_Os, s_Ls, s_Rs = (
            scvec.to_scalars(_as_array(v)) for v in (a_L, a_R, a_O, s_L, s_R)
        )
        A_I = multiscalar_mul(
            [i_blinding] + a_Ls + a_Rs, [B_blinding] + G + H
        ).compress()
        A_O = multiscalar_mul(
            [o_blinding] + a_Os, [B_blinding] + G
        ).compress()
        S = multiscalar_mul(
            [s_blinding] + s_Ls + s_Rs, [B_blinding] + G + H
        ).compress()
        return A_I, A_O, S

    def _phase_begin(
        self, gens_share, a_L, a_R, a_O, s_L, s_R,
        i_blinding, o_blinding, s_blinding, B_blinding, offset,
    ):
        """Launch the three phase-1 MSMs; returns their device
        accumulators (no sync) and, in the grid range, the blinding heads
        i/o/s_blinding * B_blinding as host points to add after the fetch
        (pallas_backend.py:317-356)."""
        assert offset == 0, "phase-2 device commitments not yet routed"
        n = len(a_L)
        dev = self.device
        a_L, a_R, a_O = _as_array(a_L), _as_array(a_R), _as_array(a_O)
        s_L, s_R = _as_array(s_L), _as_array(s_R)
        if self.walks(n):
            heads = tuple(
                B_blinding.scalar_mul(b)
                for b in (i_blinding, o_blinding, s_blinding)
            )

            def gh(x_G, x_H):
                acc = self._shared_msm(gens_share, n, "G", x_G)
                if x_H is None:
                    return acc
                return self._shared_msm(gens_share, n, "H", x_H, acc)

            return (gh(a_L, a_R), gh(a_O, None), gh(s_L, s_R)), heads
        bb = self._cached_point("Bb", B_blinding)
        G = self._gens(gens_share, n, "G")
        H = self._gens(gens_share, n, "H")
        with metrics.span("seam.launch"):
            bGH = torch.cat([bb, G, H])
        row = scvec.scalar_to_row
        accs = []
        # each MSM's words are encoded while the one before runs
        for blind, segs, pts in (
            (i_blinding, [a_L, a_R], bGH),
            (o_blinding, [a_O], bGH[: n + 1]),
            (s_blinding, [s_L, s_R], bGH),
        ):
            with metrics.span("seam.encode"):
                words = ck.segment_words([row(blind)[None], *segs], dev)
            with metrics.span("seam.launch"):
                accs.append(ck.msm_chain(pts, words))
        return tuple(accs), None

    def phase_commitments(self, *args):
        return self.phase_commitments_batch([args])[0]

    @metrics.traced("phase_commitments")
    def phase_commitments_batch(self, jobs: list[tuple]) -> list[tuple]:
        """Phase-1 vector commitments for B provers: every MSM is launched,
        then all are fetched with ONE sync.  Returns [(A_I, A_O, S)].  A
        span ``phase_commitments``, its children ``seam.encode`` /
        ``seam.launch`` / ``seam.fetch``."""
        out: list = [None] * len(jobs)
        accs, heads, order = [], [], []
        for idx, job in enumerate(jobs):
            if len(job[1]) < self.min_device_n:
                out[idx] = self._phase_host(*job)
            else:
                job_accs, job_heads = self._phase_begin(*job)
                accs.extend(job_accs)
                heads.append(job_heads)
                order.append(idx)
        if accs:
            with metrics.span("seam.fetch"):
                pts = ck.fetch_points(accs)
            for j, idx in enumerate(order):
                trio = pts[3 * j : 3 * j + 3]
                if heads[j] is not None:
                    trio = [p + h for p, h in zip(trio, heads[j])]
                out[idx] = tuple(p.compress() for p in trio)
        return out

    # ------------------------------------------------------------------ IPP
    def ipp_create(
        self, transcript, Q, G_factors, H_factors, gens_share, padded_n,
        a, b, meta=None,
    ) -> InnerProductProof:
        """Caller has already appended the ``ipp v1`` domain separator;
        `meta` (core/prover.py ipp_meta) enables the factor folds."""
        return self.ipp_create_batch(
            [(transcript, Q, G_factors, H_factors, gens_share, padded_n,
              a, b, meta)]
        )[0]

    def ipp_create_batch(self, jobs: list[tuple]) -> list[InnerProductProof]:
        """Inner-product arguments for B proofs in lockstep: per round,
        every job's L/R MSMs launch, then ONE sync fetches them all.  When
        more than one job is active and every active job is frozen, the
        round is a flotilla round: one ``msm_lane`` launch over every
        job's frozen pack (pallas_backend.py:429-537).  A thread pool runs
        the jobs' host stages; each job's transcript order is unchanged,
        only device work interleaves.

        One job is a span ``ipp_create`` (a child of the caller's open
        span, or a proof of its own), each of its rounds an ``ipp.round``
        with children ``ipp.scalars``, ``seam.encode``, ``seam.launch``,
        ``seam.fetch`` (the round's sync) and ``ipp.finish``.  Several
        jobs are one span ``ipp_create`` for the batch, each job an
        ``ipp.job`` child of it with its rounds as above, and the blocks
        a round shares (the flotilla's pack, words and launch, the one
        sync) are children of the batch's span, recorded once, so the
        batch's seam time and sync time are each counted once."""
        if len(jobs) < 2:
            return self._ipp_jobs(jobs, None)
        with metrics.span("ipp_create", root=True) as batch:
            return self._ipp_jobs(jobs, batch)

    def _ipp_jobs(self, jobs: list[tuple], batch) -> list[InnerProductProof]:
        """:meth:`ipp_create_batch`'s work; `batch` is the batch's open
        span (None for one job, or when nothing is recorded)."""
        job_span = "ipp_create" if batch is None else "ipp.job"
        out: list = [None] * len(jobs)
        states: list[tuple[int, _IppJob]] = []
        for idx, job in enumerate(jobs):
            (transcript, Q, G_factors, H_factors, gens_share, padded_n,
             a, b) = job[:8]
            if padded_n < self.min_device_n:
                with metrics.span(job_span, root=True):
                    out[idx] = InnerProductProof.create(
                        _skip_domain_sep(transcript), Q,
                        scvec.to_scalars(_as_array(G_factors)),
                        scvec.to_scalars(_as_array(H_factors)),
                        gens_share.G(padded_n), gens_share.H(padded_n),
                        scvec.to_scalars(_as_array(a)),
                        scvec.to_scalars(_as_array(b)),
                    )
            else:
                states.append((idx, _IppJob(self, *job, span=job_span)))
        if states and self.device.type == "cuda":
            build.load()  # build once, before any pool thread launches
        pool = None
        if len(states) > 1:
            pool = ThreadPoolExecutor(
                max_workers=min(len(states), max(1, (os.cpu_count() or 4) - 1))
            )
        run = pool.map if pool is not None else map
        flot_ids: tuple = ()
        flot_pts = seg = None
        try:
            while True:
                active = [s for _, s in states if s.n > 1]
                if not active:
                    break
                for s in active:
                    s.round = metrics.child(s.trace, "ipp.round",
                                            round=len(s.L_vec) + 1, m=s.n // 2)
                rounds = [s.round for s in active]
                owners = rounds if batch is None else [batch]
                if (len(active) > 1 and all(s.frozen for s in active)
                        and 2 * len(active) <= FLOTILLA_MAX_SEGMENTS):
                    ids = tuple(id(s) for s in active)
                    if ids != flot_ids:
                        seg = max(2 * s.fzS for s in active)
                        with metrics.shared("seam.launch", owners):
                            flot_pts = ck.flotilla_pack(
                                [s.fz_pack for s in active], seg
                            )
                        flot_ids = ids
                    rows = list(run(_IppJob.frozen_rows, active))
                    with metrics.shared("seam.encode", owners):
                        words = ck.flotilla_words(rows, seg, self.device)
                    with metrics.shared("seam.launch", owners):
                        totals = cc.msm_lane(flot_pts, words, 2 * len(active))
                    with metrics.shared("seam.fetch", owners):
                        pts = ck.fetch_points([totals])
                else:
                    pairs = list(run(_IppJob.round_dispatch, active))
                    with metrics.shared("seam.fetch", owners):
                        pts = ck.fetch_points(
                            [a for pair in pairs for a in pair])
                list(run(
                    lambda j: active[j].round_finish(pts[2 * j], pts[2 * j + 1]),
                    range(len(active)),
                ))
                for r in rounds:
                    metrics.end(r)
        finally:
            if pool is not None:
                pool.shutdown()
        for idx, s in states:
            out[idx] = s.result()
        return out


def _ratio_pieces(bp: int, m: int) -> tuple[int, int, int]:
    """Piecewise shape of r_i = F[i+m]/F[i] for a 2-segment factor vector
    F over [0, 2m) (value A on [0, bp), B on [bp, 2m), rho = B/A):
    r_i = rho^powA for i < rbp else rho^powB.  Returns (powA, powB, rbp).

    The engine's G_factors are [1]*n1 + [u]*rest and H_factors multiply
    in a geometric y^-i (core/prover.py:_prove_middle), and a fold scales
    the surviving half by one constant, so this 2-segment structure (and
    rho == the phase challenge u) holds in every IPP round."""
    if bp <= m:
        return 1, 0, bp
    return 0, 1, bp - m


def _pw_rows(cA, cB, rbp: int, m: int) -> np.ndarray:
    """(m, 4) u64 array: cA for index < rbp, cB beyond."""
    j = min(max(rbp, 0), m)
    return np.concatenate([
        np.tile(scvec.scalar_to_row(cA), (j, 1)),
        np.tile(scvec.scalar_to_row(cB), (m - j, 1)),
    ])


_ONES_ROWS_CACHE: dict[int, np.ndarray] = {}


def _ones_rows(m: int) -> np.ndarray:
    got = _ONES_ROWS_CACHE.get(m)
    if got is None:
        got = ck.const_rows(Scalar.one(), m)
        _ONES_ROWS_CACHE[m] = got
    return got


# ------------------------------------------------------------- frozen tail
# Once both generator vectors are small (side S <= frozen_max_side), the
# remaining rounds stop folding generators: the vectors are PINNED at size
# S and every round is expressed over them with composite scalars.  A
# skipped fold D'_i = D_i + c_i * D_{i+mu} is absorbed into per-frozen-
# index factor vectors FF (host, (S, 4) u64), and a round's L and R MSMs
# become ONE msm_w4_pair launch over [G(S) | H(S)] duplicated (L words on
# the first copy, R words on the second).  The c_L*Q / c_R*Q terms are
# host scalar_muls added in round_finish.  Proof bytes are unchanged (the
# L/R points are the same group elements).
def frozen_fold_update(FF: np.ndarray, mu: int, rbp: int, cA, cB
                       ) -> np.ndarray:
    """Absorb one skipped generator fold (virtual size 2*mu -> mu, fold
    constant cA for output index < rbp else cB) into the frozen factor
    vector: FF'_k = FF_k * c_{(k mod 2mu) - mu} when (k mod 2mu) >= mu."""
    S = FF.shape[0]
    k = np.arange(S)
    v = k % (2 * mu)
    hi = v >= mu
    i = np.where(hi, v - mu, 0)
    c_rows = np.where(
        hi[:, None],
        np.where((i < rbp)[:, None], scvec.scalar_to_row(cA),
                 scvec.scalar_to_row(cB)),
        scvec.scalar_to_row(Scalar.one()),
    ).astype(np.uint64)
    return scvec.mul(FF, np.ascontiguousarray(c_rows))


def frozen_walk_rows(
    S: int, m: int, scG_L, scH_L, scG_R, scH_R, FFG, FFH,
) -> tuple[np.ndarray, np.ndarray]:
    """Composite MSM scalar rows for one frozen round (virtual size
    2m -> m).  Returns (rowsL, rowsR), each (2S, 4) u64 over the packed
    layout [G(S) | H(S)]:

      L = <scG_L, G'[m:2m)> + <scH_L, H'[0:m)>     (+ c_L*Q on host)
      R = <scG_R, G'[0:m)>  + <scH_R, H'[m:2m)>    (+ c_R*Q on host)

    where virtual gen j = sum_{k = j mod 2m} FF_k * frozen_k."""
    k = np.arange(S)
    v = k % (2 * m)
    hi = v >= m
    zero = np.zeros((1, 4), np.uint64)

    def gather(t, idx, mask):
        return np.ascontiguousarray(
            np.where(mask[:, None], t[idx], zero).astype(np.uint64)
        )

    g_L = scvec.mul(gather(scG_L, np.where(hi, v - m, 0), hi), FFG)
    h_L = scvec.mul(gather(scH_L, np.where(hi, 0, v), ~hi), FFH)
    g_R = scvec.mul(gather(scG_R, np.where(hi, 0, v), ~hi), FFG)
    h_R = scvec.mul(gather(scH_R, np.where(hi, v - m, 0), hi), FFH)
    return np.concatenate([g_L, h_L]), np.concatenate([g_R, h_R])


def _in_round(step):
    """A job's step runs under the job's open ``ipp.round`` span, on
    whichever thread the batch's pool gives it."""
    @functools.wraps(step)
    def run(self, *args):
        with metrics.adopt(self.round):
            return step(self, *args)
    return run


class _IppJob:
    """Per-proof state of a device-backed IPP, advanced one round at a
    time by :meth:`TorchBackend.ipp_create_batch`.

    Generator folding uses host-tracked factor vectors: the device tensors
    hold D with true folded gens G' = F_i * D_i; each round folds D by
    out = D_L + c * D_R with at most two c values (one breakpoint, see
    :func:`_ratio_pieces`), and F folds by one scalar on host.  The
    factors multiply into the L/R MSM *scalars*, so a fold needs no
    per-point scalars: a constant fold ``fold_c``, a ``fold_bits`` launch
    with ones on the left, or a half-width ``fold_w3h(_comb)`` launch by
    beta * D_L + alpha * D_R with beta^-1 folded into F.  In the grid
    range round 1 walks the unfolded generators over the shared tables;
    then, with enough points left, the job moves to the combined layout
    (C = [G' | H'] and its ``table_w4`` table, one ``msm_win_pair`` and
    one ``fold_w3h_comb`` per round) while n >= COMB_MIN_N, and with
    fewer (padded n = 2 * COMB_MIN_N) round 1 folds each side with
    ``fold_c``.  The rounds after take the chunk-list route (``msm_w4``
    per side, ``fold_bits``) until both sides fit the frozen side cap;
    then the job switches to the frozen tail (one ``msm_w4_pair`` launch
    per round, or its share of a batch's ``msm_lane`` launch; no folds).
    Q terms are added on host in round_finish.  The module docstring
    lists the kernels of each branch."""

    def __init__(
        self, backend: TorchBackend, transcript, Q, G_factors, H_factors,
        gens_share, padded_n, a, b, meta=None, span="ipp_create",
    ):
        # the job's span, and its open round's: handed to the pool
        # threads that run its steps
        self.trace = metrics.begin(span)
        self.round = None
        self.dev = backend.device
        self.max_side = backend.frozen_max_side
        self.t = transcript
        self.n = padded_n
        self.a = _as_array(a)
        self.b = _as_array(b)
        self.GF = _as_array(G_factors)
        self.HF = _as_array(H_factors)
        meta = meta or {}
        self.bp = min(int(meta.get("n1", padded_n)), padded_n)
        # 2-piece factor structure: ratio rho per side (starts at the
        # phase challenge u), breakpoint bp
        self.rho_G = self.rho_H = meta.get("u", Scalar.one())
        self.y_inv = meta.get("y_inv", Scalar.one())
        # a is zero beyond the real multiplier count until the first fold
        self._a_nz = int(meta.get("n_real", padded_n))
        self.Qpt = Q
        self.frozen = False
        self.fz_pack = self.fz = None
        self.fzS = 0
        self.FFG = self.FFH = None
        self.L_vec: list[bytes] = []
        self.R_vec: list[bytes] = []
        self.G = backend._gens(gens_share, padded_n, "G")
        self.H = backend._gens(gens_share, padded_n, "H")
        self.tG = self.tH = None
        # combined layout [G' | H'] and its w4 table (rounds 2+ while
        # n >= COMB_MIN_N, after a walker round 1)
        self.C = self.tC = None
        self._walked = False  # this round walked the shared tables
        if padded_n <= self.max_side:
            # small proof: frozen from round 1, no generator folds at all
            self._freeze(self.G, self.H, padded_n)
        elif backend.walks(padded_n):
            # grid range: round 1 walks the unfolded generators over the
            # shared tables (G / H are the shared generator cache until
            # the first fold, the job's own tensors after it)
            self.tG = backend._gens_table(gens_share, padded_n, "G")
            self.tH = backend._gens_table(gens_share, padded_n, "H")

    def _freeze(self, G, H, S: int) -> None:
        """Enter frozen-tail mode with side size S (factor vectors start
        at one; callers absorb a skipped fold with frozen_fold_update).
        The pair kernel's duplicated pack is built at its first use:
        flotilla rounds walk the batch's pack instead."""
        self.fz_pack = ck.frozen_pack(G, H, S)
        self.fz = None
        self.frozen = True
        self.fzS = S
        self.FFG = _ones_rows(S).copy()
        self.FFH = _ones_rows(S).copy()
        self.G = self.H = None

    def _round_scalars(self):
        """Halve n and compute this round's host scalar operands."""
        self.n //= 2
        n = self.n
        a_L, a_R = self.a[:n], self.a[n:]
        b_L, b_R = self.b[:n], self.b[n:]
        self._halves = (a_L, a_R, b_L, b_R)
        self.c_L = scvec.inner(a_L, b_R)
        self.c_R = scvec.inner(a_R, b_L)
        # MSM scalars carry the host-tracked generator factors every round
        scG_L = scvec.mul(a_L, self.GF[n : 2 * n])
        scH_L = scvec.mul(b_R, self.HF[:n])
        scG_R = scvec.mul(a_R, self.GF[:n])
        scH_R = scvec.mul(b_L, self.HF[n : 2 * n])
        # a_R is zero beyond nzR in round 1 (dense after the first fold)
        a_nz, self._a_nz = self._a_nz, 2 * n
        self._nzR = max(0, min(a_nz - n, n))
        return scG_L, scH_L, scG_R, scH_R

    @_in_round
    def frozen_rows(self):
        """One frozen round's host step: halve n and return the composite
        (rowsL, rowsR) over [G(S) | H(S)] (a flotilla round packs many
        jobs' rows into one launch)."""
        with metrics.span("ipp.scalars"):
            scG_L, scH_L, scG_R, scH_R = self._round_scalars()
            return frozen_walk_rows(
                self.fzS, self.n, scG_L, scH_L, scG_R, scH_R, self.FFG,
                self.FFH,
            )

    @_in_round
    def round_dispatch(self):
        """Halve n, compute this round's scalars on host and launch the L/R
        MSMs; returns the (accL, accR) device accumulators (no sync)."""
        if self.frozen:
            rowsL, rowsR = self.frozen_rows()
            with metrics.span("seam.encode"):
                words = ck.segment_words([rowsL, rowsR], self.dev)
            with metrics.span("seam.launch"):
                if self.fz is None:
                    self.fz = torch.cat([self.fz_pack, self.fz_pack])
                pair = cc.msm_w4_pair(
                    self.fz, words, F.identity_points(2, self.dev),
                    2 * self.fzS,
                )
            return pair[0:1], pair[1:2]
        with metrics.span("ipp.scalars"):
            scG_L, scH_L, scG_R, scH_R = self._round_scalars()
        n = self.n
        if self.C is not None:
            # combined round (pallas_backend.py:841-872): words
            # [scG_L | scH_L | scG_R | scH_R]; both walks in ONE launch
            with metrics.span("seam.encode"):
                words = ck.w4_words(
                    np.concatenate([scG_L, scH_L, scG_R, scH_R]), self.dev
                )
            with metrics.span("seam.launch"):
                pair = cc.msm_win_pair(
                    self.tC, words, F.identity_points(2, self.dev),
                    ck.comb_walks(n),
                )
            return pair[0:1], pair[1:2]
        if self.tG is not None:
            # round 1 over the shared tables (pallas_backend.py:873-884):
            # G words [scG_R | scG_L], H words [scH_L | scH_R]; R's G part
            # stops at a_R's zero tail
            vR = max(1, self._nzR) if self._nzR < n else n
            with metrics.span("seam.encode"):
                wG = ck.w5_words(np.concatenate([scG_R, scG_L]), self.dev)
                wH = ck.w5_words(np.concatenate([scH_L, scH_R]), self.dev)
            with metrics.span("seam.launch"):
                ident = F.identity_points(1, self.dev)
                accL = cc.msm_win5(self.tG, wG, ident, n, poff=n, woff=n)
                accL = cc.msm_win5(self.tH, wH, accL, n)
                accR = cc.msm_win5(self.tG, wG, ident, vR)
                accR = cc.msm_win5(self.tH, wH, accR, n, poff=n, woff=n)
            self.tG = self.tH = None
            self._walked = True
            return accL, accR
        with metrics.span("seam.launch"):
            ptsL, ptsR = ck.pack_pair(self.G, self.H, n)
        accs = []
        for pts, sides in ((ptsL, [scG_L, scH_L]), (ptsR, [scG_R, scH_R])):
            with metrics.span("seam.encode"):
                words = ck.segment_words(sides, self.dev)
            with metrics.span("seam.launch"):
                accs.append(ck.msm_chain(pts, words))
        return tuple(accs)

    @_in_round
    def round_finish(self, L_pt, R_pt) -> None:
        """Add the Q terms, append L/R, take the challenge, fold a/b and
        the factor vectors on host (``ipp.finish``), and launch the
        generator folds."""
        metrics.mark("ipp.finish")
        n = self.n
        a_L, a_R, b_L, b_R = self._halves
        L_pt = L_pt + self.Qpt.scalar_mul(self.c_L)
        R_pt = R_pt + self.Qpt.scalar_mul(self.c_R)
        L_c = L_pt.compress()
        R_c = R_pt.compress()
        self.L_vec.append(L_c)
        self.R_vec.append(R_c)
        self.t.append_point(b"L", L_c)
        self.t.append_point(b"R", R_c)
        u = self.t.challenge_scalar(b"u")
        u_inv = u.invert()
        self.a = scvec.axpby(a_L, u, a_R, u_inv)
        self.b = scvec.axpby(b_L, u_inv, b_R, u)
        # fold constants: D'_i = D_i + c_i * D_{i+n} with c_i in {cA, cB}
        # split at rbp (G side: true fold u_inv*G'_L + u*G'_R; H side:
        # u*H'_L + u_inv*H'_R with the geometric y^-n ratio)
        powA, powB, rbp = _ratio_pieces(self.bp, n)
        one = Scalar.one()
        u2 = u * u
        hfac = u_inv * u_inv * Scalar(pow(self.y_inv.v, n, _L))
        cG = (
            u2 * (self.rho_G if powA else one),
            u2 * (self.rho_G if powB else one),
        )
        cH = (
            hfac * (self.rho_H if powA else one),
            hfac * (self.rho_H if powB else one),
        )
        walked, self._walked = self._walked, False
        # round 1 -> combined layout after a walker round 1 with enough
        # points left (pallas_backend.py:1047-1068)
        to_comb = walked and n >= 2 * COMB_MIN_N
        # half-width splits on the combined rounds and the round-1
        # transition (pallas_backend.py:964-1004): beta^-1 folds into the
        # factor vectors, so the pieces' ratio picks up beta_A / beta_B
        use_w3h = self.C is not None or to_comb
        if use_w3h:
            sG = [ck.half_gcd_split(c.v, _L) for c in cG]
            sH = [ck.half_gcd_split(c.v, _L) for c in cH]
            bGi = [Scalar(s[1] % _L).invert() for s in sG]
            bHi = [Scalar(s[1] % _L).invert() for s in sH]
            self.GF = scvec.mul(
                self.GF[:n], _pw_rows(u_inv * bGi[0], u_inv * bGi[1], rbp, n)
            )
            self.HF = scvec.mul(
                self.HF[:n], _pw_rows(u * bHi[0], u * bHi[1], rbp, n)
            )
            ratio_G = Scalar(sG[0][1] % _L) * bGi[1]
            ratio_H = Scalar(sH[0][1] % _L) * bHi[1]
        else:
            sG = sH = None
            self.GF = scvec.scale(self.GF[:n], u_inv)
            self.HF = scvec.scale(self.HF[:n], u)
            ratio_G = ratio_H = one
        # the factor vectors stay 2-piece with breakpoint bp and ratio rho:
        #   bp <= n: bp' = bp,     rho' = rho * beta_A / beta_B
        #   bp >  n: bp' = bp - n, rho' = beta_A / beta_B
        if self.bp <= n:
            self.rho_G = self.rho_G * ratio_G
            self.rho_H = self.rho_H * ratio_H
        else:
            self.rho_G, self.rho_H = ratio_G, ratio_H
            self.bp = self.bp - n
        if self.frozen:
            self.FFG = frozen_fold_update(self.FFG, n, rbp, cG[0], cG[1])
            self.FFH = frozen_fold_update(self.FFH, n, rbp, cH[0], cH[1])
            return
        metrics.mark(None)
        if self.C is not None:
            # combined fold (pallas_backend.py:1027-1046): both sides into
            # a NEW tensor (blocks run in any order, so never in place),
            # half-width; then the next round's table in the old table's
            # storage, or the tail once the sides are one chunk
            with metrics.span("seam.encode"):
                words = ck.w3h_fold_words([sG, sH], self.dev)
            with metrics.span("seam.launch"):
                self.C = cc.fold_w3h_comb(self.C, words, rbp)
                if n >= 2 * COMB_MIN_N:
                    self.tC = cc.table_w4(self.C, out=self.tC)
                else:
                    self.G, self.H = self.C[:n], self.C[n : 2 * n]
                    self.C = self.tC = None
            return
        if to_comb:
            # round 1 -> combined layout (pallas_backend.py:1047-1068):
            # each side folds into its half of C, one table over both
            C = torch.empty((2 * n, 4, 8), dtype=torch.int32, device=self.dev)
            for k, (src, split) in enumerate(((self.G, sG), (self.H, sH))):
                with metrics.span("seam.encode"):
                    words = ck.w3h_fold_words([split], self.dev)
                with metrics.span("seam.launch"):
                    cc.fold_w3h(src[: 2 * n], words, rbp,
                                out=C[k * n : (k + 1) * n])
            with metrics.span("seam.launch"):
                self.tC = cc.table_w4(C)
            self.C, self.G, self.H = C, None, None
            return
        if walked and n >= COMB_MIN_N:
            # grid fold (pallas_backend.py:1069-1076): padded n = 4096's
            # round 1, one fold by the constants per side
            with metrics.span("seam.encode"):
                wG = ck.c_fold_words([cG], self.dev)
                wH = ck.c_fold_words([cH], self.dev)
            with metrics.span("seam.launch"):
                self.G = cc.fold_c(self.G[: 2 * n], wG, rbp)
                self.H = cc.fold_c(self.H[: 2 * n], wH, rbp)
            return
        if n <= self.max_side // 2:
            # both sides (size 2n) fit the cap: freeze pre-fold and absorb
            # THIS round's fold into the fresh factor vectors
            self._freeze(self.G, self.H, 2 * n)
            self.FFG = frozen_fold_update(self.FFG, n, rbp, cG[0], cG[1])
            self.FFH = frozen_fold_update(self.FFH, n, rbp, cH[0], cH[1])
            return
        # one upload of the three word arrays: wl (ones), G's and H's rows
        with metrics.span("seam.encode"):
            wl, wgr, whr = ck.fold_words(np.concatenate([
                _ones_rows(n), _pw_rows(cG[0], cG[1], rbp, n),
                _pw_rows(cH[0], cH[1], rbp, n),
            ]), self.dev).view(3, n, 8)
        with metrics.span("seam.launch"):
            self.G = cc.fold_bits(self.G[:n], self.G[n : 2 * n], wl, wgr)
            self.H = cc.fold_bits(self.H[:n], self.H[n : 2 * n], wl, whr)

    def result(self) -> InnerProductProof:
        metrics.end(self.trace)
        return InnerProductProof(
            self.L_vec, self.R_vec,
            scvec.row_to_scalar(self.a[0]), scvec.row_to_scalar(self.b[0]),
        )
