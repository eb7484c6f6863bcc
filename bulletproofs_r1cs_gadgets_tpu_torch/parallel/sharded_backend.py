"""Multi-device MSM sharding of the device-oracle backend: the
counterpart of the JAX package's ``parallel/sharded_backend.py``.

:class:`ShardedMsmBackend` is ``DeviceBackend`` with the point axis of
every device MSM (the phase-1 commitments, each IPP round's L and R, the
verifier's mega-MSM) split over a list of devices, or over one axis of a
:class:`.mesh.Mesh`:

* shard d takes one contiguous slice of the points and of the scalars'
  bit words (``ck.bit_words``, as ``msm_device`` reads them), placed on
  its device (every upload first), and sums it by ``msm_device``'s rule:
  chained ``msm_chunk_acc`` launches of ``CHUNK`` points;
* every shard's launches are made before any result is waited on; the
  ``(4, 8)`` partials are gathered onto the first shard's device and
  added there (``mesh.sum_partials``: the reference's ``all_gather`` and
  ``point_add``, the ``padd`` kernel).

The reference turns the scalars into base-2^w window digits and pads
every MSM with identity points to whole ``chunk``s so that ``shard_map``
compiles one shape.  The kernel reads bit words and takes any n, so
neither is done here: ``chunk`` and ``window`` are accepted for the
reference's signature and change no work.

:class:`BatchShardedBackend` adds the batch axis of a ``(batch, points)``
mesh: B same-shape jobs are split into contiguous blocks over the mesh's
rows (as ``PSpec(batch)`` splits them), each job's MSMs are sharded over
its row's devices, all B jobs' L and R MSMs of an IPP round are launched
before the round's one sync, and the B transcripts advance on the host
between rounds.  Each job folds its generators with one ``fold_grid``
launch a side and round on its row's first device.  Heterogeneous
batches (and the reference's other fallback conditions) take the per-job
path.

A device list may repeat a device, so one card can hold four shards; the
default is every visible card (raising without one).  Proof bytes equal
``DeviceBackend``'s and the host path's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import scvec as _scvec
from ..core.ipp import InnerProductProof
from ..ops import chunks as ck
from ..ops.backend import DeviceBackend, _fold_with_scalars, fold_points
from ..ops.msm import CHUNK, WINDOW, msm_words, scalar_rows
from .mesh import Mesh, cuda_devices, even_spans, make_mesh, sum_partials


def _canon(device) -> torch.device:
    """A device with its index ("cuda" is the current card)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _rows(x) -> np.ndarray:
    return (np.ascontiguousarray(x) if isinstance(x, np.ndarray)
            else _scvec.from_scalars(list(x)))


class ShardedMsmBackend(DeviceBackend):
    """DeviceBackend with the point axis of every MSM sharded over
    `mesh_or_devices`: a device list, or the `axis` of a mesh (default
    every visible card).  The first shard's device is the lead: it holds
    the generators, gathers the partials and runs the folds.  Everything
    else (host fallbacks below ``min_device_n``, generator caching, the
    IPP folds) is ``DeviceBackend``'s.

    ``chunk`` and ``window`` are the reference's arguments, kept for its
    signature: the shards read bit words and launch ``CHUNK`` points at a
    time whatever they are."""

    def __init__(
        self,
        mesh_or_devices=None,
        axis: str = "points",
        min_device_n: int = 512,
        chunk: int = CHUNK,
        window: int = WINDOW,
    ):
        if mesh_or_devices is None:
            mesh_or_devices = cuda_devices()
        self.mesh = mesh_or_devices if isinstance(mesh_or_devices, Mesh) else None
        if self.mesh is not None:
            devices = self.mesh.axis_devices(axis)
        else:
            devices = [torch.device(d) for d in mesh_or_devices]
        if not devices:
            raise ValueError("a sharded backend needs devices")
        super().__init__(devices[0], min_device_n=min_device_n)
        self.devices = [_canon(d) for d in devices]
        self.axis = axis
        self.n_shards = len(devices)
        self.chunk = chunk
        self.window = window

    def __repr__(self) -> str:
        distinct = list(dict.fromkeys(str(d) for d in self.devices))
        return (f"{type(self).__name__}({self.n_shards} shards on "
                f"{', '.join(distinct)})")

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _launch_sharded(devices: list, rows: np.ndarray,
                        points: torch.Tensor) -> torch.Tensor:
        """Launch the MSM of scalar `rows` over `points`, sharded over
        `devices` (no sync): the (4, 8) total on devices[0].  Every
        shard's slice is placed before any launch."""
        words = torch.from_numpy(ck.bit_words(rows))
        spans = even_spans(points.shape[0], len(devices))
        placed = [(points[lo:hi].to(dev), words[lo:hi].to(dev))
                  for (lo, hi), dev in zip(spans, devices)]
        return sum_partials([msm_words(w, p, CHUNK) for p, w in placed],
                            devices[0])

    def _msm_dev(self, scalars, dev: torch.Tensor) -> torch.Tensor:
        """Every device MSM of the engine: sharded over the devices."""
        return self._launch_sharded(self.devices, scalar_rows(scalars), dev)


class BatchShardedBackend(ShardedMsmBackend):
    """Two-axis proving over a ``(batch, points)`` mesh (default: every
    visible card, split by ``make_mesh``'s rule): B independent same-shape
    proofs ride the ``batch`` axis as data parallelism, and each proof's
    MSMs are sharded over its row's ``points`` devices.

    Per IPP round every job's L and R MSMs are launched, then one sync
    fetches all 2B points; the B Fiat-Shamir transcripts advance on the
    host between rounds.  Jobs must share one circuit shape (same
    padded_n and generator set), start at offset 0, reach
    ``min_device_n`` and fill the batch rows evenly; otherwise the batch
    falls back to the per-job path (the reference's conditions)."""

    def __init__(self, mesh: Mesh | None = None, batch_axis: str = "batch",
                 **kw):
        mesh = make_mesh() if mesh is None else mesh
        super().__init__(mesh, **kw)
        self.batch_axis = batch_axis
        self.n_batch = mesh.shape[batch_axis]
        self.rows = [[_canon(d) for d in row] for row in mesh.rows(batch_axis)]
        self._row_gens: dict = {}

    # ------------------------------------------------------------ helpers
    def _row_of(self, j: int, B: int) -> list:
        """The devices of job j's batch row (contiguous blocks of B jobs)."""
        return self.rows[j // (B // self.n_batch)]

    def _gens_on(self, gens_share, n: int, which: str, device) -> torch.Tensor:
        """The first n G or H generators on `device` (cached)."""
        if device == self.device:
            return self._gens_device(gens_share, n, which)
        key = (id(gens_share._gens), which, str(device))
        got = self._row_gens.get(key)
        if got is None or got.shape[0] < n:
            got = self._gens_device(gens_share, n, which).to(device)
            self._row_gens[key] = got
        return got[:n]

    def _fetch(self, totals: list) -> list:
        """ONE sync for the (4, 8) totals of every job, on any rows."""
        return ck.fetch_points([torch.stack([t.to(self.device)
                                             for t in totals])])

    def _msm_batch(self, rows_list: list, points_list: list) -> list:
        """B MSMs, job j's over its row's devices, all launched before
        anything waits: (4, 8) totals."""
        B = len(points_list)
        return [self._launch_sharded(self._row_of(j, B), rows, pts)
                for j, (rows, pts) in enumerate(zip(rows_list, points_list))]

    @staticmethod
    def _jobs_uniform(ns: list, genses: list) -> bool:
        return len(set(ns)) == 1 and len({id(g) for g in genses}) == 1

    # ----------------------------------------------------- batched phase 1
    def phase_commitments_batch(self, jobs: list[tuple]) -> list[tuple]:
        norm = []
        for job in jobs:
            (gens_share, a_L, a_R, a_O, s_L, s_R,
             i_b, o_b, s_b, B_blinding, offset) = job
            norm.append((gens_share, _rows(a_L), _rows(a_R), _rows(a_O),
                         _rows(s_L), _rows(s_R), i_b, o_b, s_b, B_blinding,
                         offset))
        ns = [len(j[1]) for j in norm]
        if (
            not self._jobs_uniform(ns, [j[0]._gens for j in norm])
            or any(j[10] != 0 for j in norm)
            or ns[0] < self.min_device_n
            or len(norm) % self.n_batch != 0
        ):
            return [self.phase_commitments(*job) for job in jobs]
        n, B = ns[0], len(norm)
        gens_share = norm[0][0]
        GH, G = [], []
        for j in range(B):
            lead = self._row_of(j, B)[0]
            g = self._gens_on(gens_share, n, "G", lead)
            G.append(g)
            GH.append(torch.cat([g, self._gens_on(gens_share, n, "H", lead)]))
        totals = (
            self._msm_batch([np.concatenate([j[1], j[2]]) for j in norm], GH)
            + self._msm_batch([j[3] for j in norm], G)
            + self._msm_batch([np.concatenate([j[4], j[5]]) for j in norm], GH)
        )
        pts = self._fetch(totals)
        AI, AO, S = pts[:B], pts[B : 2 * B], pts[2 * B :]
        out = []
        for j, (_, _, _, _, _, _, i_b, o_b, s_b, Bb, _) in enumerate(norm):
            out.append((
                (AI[j] + Bb.scalar_mul(i_b)).compress(),
                (AO[j] + Bb.scalar_mul(o_b)).compress(),
                (S[j] + Bb.scalar_mul(s_b)).compress(),
            ))
        return out

    # --------------------------------------------------------- batched IPP
    def ipp_create_batch(self, jobs: list[tuple]) -> list:
        """The per-round scalar math runs on the C++ scvec layer over
        (n, 4) u64 arrays; each job's generators live on its row's first
        device and fold there (``_fold_with_scalars`` in round 1, then
        ``fold_points`` with the round's constants)."""
        norm = [
            (t, Q, _rows(gf), _rows(hf), gens_share, padded_n, _rows(a),
             _rows(b))
            for (t, Q, gf, hf, gens_share, padded_n, a, b) in
            (job[:8] for job in jobs)
        ]
        ns = [j[5] for j in norm]
        if (
            not self._jobs_uniform(ns, [j[4]._gens for j in norm])
            or ns[0] < self.min_device_n
            or len(norm) % self.n_batch != 0
        ):
            return [self.ipp_create(*job) for job in jobs]
        n, B = ns[0], len(norm)
        gens_share = norm[0][4]
        st = []
        for j, (t, Q, gf, hf, _gs, _n, a, b) in enumerate(norm):
            lead = self._row_of(j, B)[0]
            st.append({
                "t": t, "Q": Q, "gf": gf, "hf": hf, "a": a, "b": b,
                "L": [], "R": [],
                "G": self._gens_on(gens_share, n, "G", lead),
                "H": self._gens_on(gens_share, n, "H", lead),
            })
        first = True
        while n != 1:
            n //= 2
            # host: this round's MSM scalars + Q coefficients per job
            scL_rows, scR_rows, cLs, cRs = [], [], [], []
            for s in st:
                a_L, a_R = s["a"][:n], s["a"][n:]
                b_L, b_R = s["b"][:n], s["b"][n:]
                cLs.append(_scvec.inner(a_L, b_R))
                cRs.append(_scvec.inner(a_R, b_L))
                if first:
                    gf, hf = s["gf"], s["hf"]
                    scL_rows.append(np.concatenate([
                        _scvec.mul(a_L, gf[n : 2 * n]),
                        _scvec.mul(b_R, hf[:n]),
                    ]))
                    scR_rows.append(np.concatenate([
                        _scvec.mul(a_R, gf[:n]),
                        _scvec.mul(b_L, hf[n : 2 * n]),
                    ]))
                else:
                    scL_rows.append(np.concatenate([a_L, b_R]))
                    scR_rows.append(np.concatenate([a_R, b_L]))
                s["halves"] = (a_L, a_R, b_L, b_R)
            # device: all B L and R MSMs launched, then one sync
            ptsL = [torch.cat([s["G"][n:], s["H"][:n]]) for s in st]
            ptsR = [torch.cat([s["G"][:n], s["H"][n:]]) for s in st]
            pts = self._fetch(self._msm_batch(scL_rows, ptsL)
                              + self._msm_batch(scR_rows, ptsR))
            L_pts, R_pts = pts[:B], pts[B:]
            # host: transcripts advance independently; device: each job's
            # generators fold on its row's first device
            for j, s in enumerate(st):
                L_c = (L_pts[j] + s["Q"].scalar_mul(cLs[j])).compress()
                R_c = (R_pts[j] + s["Q"].scalar_mul(cRs[j])).compress()
                s["L"].append(L_c)
                s["R"].append(R_c)
                s["t"].append_point(b"L", L_c)
                s["t"].append_point(b"R", R_c)
                u = s["t"].challenge_scalar(b"u")
                u_inv = u.invert()
                a_L, a_R, b_L, b_R = s["halves"]
                s["a"] = _scvec.axpby(a_L, u, a_R, u_inv)
                s["b"] = _scvec.axpby(b_L, u_inv, b_R, u)
                if first:
                    gf, hf = s["gf"], s["hf"]
                    s["G"] = _fold_with_scalars(
                        s["G"], _scvec.scale(gf[:n], u_inv),
                        _scvec.scale(gf[n : 2 * n], u))
                    s["H"] = _fold_with_scalars(
                        s["H"], _scvec.scale(hf[:n], u),
                        _scvec.scale(hf[n : 2 * n], u_inv))
                else:
                    s["G"] = fold_points(s["G"], u_inv, u)
                    s["H"] = fold_points(s["H"], u, u_inv)
            first = False
        return [
            InnerProductProof(
                s["L"], s["R"],
                _scvec.row_to_scalar(s["a"][0]),
                _scvec.row_to_scalar(s["b"][0]),
            )
            for s in st
        ]
