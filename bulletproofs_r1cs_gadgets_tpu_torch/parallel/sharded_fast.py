"""Points-axis sharding of the fast path's MSM walk.

The counterpart of the JAX package's ``parallel/sharded_fast.py``.  One
MSM over a span of ``n_shards * local_chunks`` chunks of ``ck.CHUNK``
points (the port's flat ``(n, 4, 8)`` points and ``(n, 8)`` signed w4
words) is split chunk-wise over a list of devices, or over one axis of a
:class:`..parallel.mesh.Mesh`:

* shard d holds chunks [d * lc, (d + 1) * lc), placed on its device, and
  walks them with its own clamped valid count (``ck.shard_valid``: chunks
  at or past the span's valid count add nothing);
* every shard's walk is launched before any is waited on;
* the partial points, one ``(1, 4, 8)`` accumulator per shard, are
  gathered onto the first shard's device (the reference's ``all_gather``)
  and folded there with the point ops of ``ops/curve.py`` (the
  reference's XLA ``point_add``), then fetched with one sync.

The local walk has one contract, ``walk(points, words, acc, valid)`` ->
``(1, 4, 8)``:

* :func:`local_walk_cuda`, the default: the ``msm_grid_local`` kernel
  (the reference's ``local_walk_pallas``);
* :func:`local_walk_plain`: its plain torch version (the reference's
  ``local_walk_xla``), for tests.

A device list may repeat a device: one card then walks several shards,
one after another on its stream, as the JAX tests run eight virtual CPU
devices.  The repr says how many distinct devices hold the shards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import scvec
from ..core.ristretto import RistrettoPoint, multiscalar_mul
from ..ops import chunks as ck
from ..ops import cuda_curve as cc
from ..ops import curve as C
from ..ops import field as F
from .mesh import Mesh


# --------------------------------------------------------- local walks
def local_walk_cuda(points: torch.Tensor, words: torch.Tensor,
                    acc: torch.Tensor, valid: int) -> torch.Tensor:
    """The shard's walk on the ``msm_grid_local`` kernel."""
    return cc.msm_grid_local(points, words, acc, valid, ck.CHUNK)


def local_walk_plain(points: torch.Tensor, words: torch.Tensor,
                     acc: torch.Tensor, valid: int) -> torch.Tensor:
    """The shard's walk on the kernel's plain version (tests only)."""
    return cc.msm_grid_local_plain(points, words, acc, valid, ck.CHUNK)


class ShardedWalkMsm:
    """One MSM sharded chunk-wise over `mesh_or_devices` (a device list,
    or the `axis` of a mesh); see the module docstring.  Each shard is
    ``local_chunks`` chunks of ``ck.CHUNK`` points.  ``local_walk``
    defaults to the kernel (:func:`local_walk_cuda`)."""

    def __init__(self, mesh_or_devices, axis: str = "points",
                 local_chunks: int = 2, local_walk=None):
        if isinstance(mesh_or_devices, Mesh):
            devices = mesh_or_devices.axis_devices(axis)
        else:
            devices = [torch.device(d) for d in mesh_or_devices]
        if not devices or local_chunks < 1:
            raise ValueError("a sharded walk needs devices and chunks")
        self.devices = devices
        self.n_shards = len(devices)
        self.local_chunks = local_chunks
        self.total_chunks = self.n_shards * local_chunks
        self.local_walk = local_walk or local_walk_cuda

    def __repr__(self) -> str:
        distinct = list(dict.fromkeys(str(d) for d in self.devices))
        where = ", ".join(distinct)
        if len(distinct) < self.n_shards:
            where += (f" ({self.n_shards} shards on {len(distinct)} "
                      f"device{'s' if len(distinct) > 1 else ''})")
        return (f"ShardedWalkMsm({self.n_shards} shards x "
                f"{self.local_chunks} chunks of {ck.CHUNK} points over "
                f"{where})")

    @property
    def shard_points(self) -> int:
        return self.local_chunks * ck.CHUNK

    def place(self, points: torch.Tensor) -> list[torch.Tensor]:
        """The span's (total_chunks * CHUNK, 4, 8) points as one tensor
        per shard, on the shard's device (to reuse across walks)."""
        w = self.shard_points
        if tuple(points.shape) != (self.n_shards * w, 4, 8):
            raise ValueError(
                f"{tuple(points.shape)} points for a span of "
                f"{self.n_shards * w}"
            )
        return [points[d * w : (d + 1) * w].to(dev).contiguous()
                for d, dev in enumerate(self.devices)]

    def msm_async(self, points, words: torch.Tensor, valid_chunks: int
                  ) -> torch.Tensor:
        """The total as a (1, 4, 8) tensor on the first shard's device, no
        sync.  `points`: the span's points, or their shards from
        :meth:`place`; `words`: (span, 8) signed w4 words on any device;
        chunks from `valid_chunks` on add nothing."""
        w = self.shard_points
        shards = points if isinstance(points, list) else self.place(points)
        if len(shards) != self.n_shards or any(
            tuple(s.shape) != (w, 4, 8) for s in shards
        ):
            raise ValueError("points do not match the shards")
        if tuple(words.shape) != (self.n_shards * w, 8):
            raise ValueError(f"words {tuple(words.shape)} for a span of "
                             f"{self.n_shards * w}")
        if not 1 <= valid_chunks <= self.total_chunks:
            raise ValueError(f"{valid_chunks} valid chunks of "
                             f"{self.total_chunks}")
        # every upload, then every walk, before anything waits
        wshards = [words[d * w : (d + 1) * w].to(dev).contiguous()
                   for d, dev in enumerate(self.devices)]
        parts = [
            self.local_walk(
                shards[d], wshards[d], F.identity_points(1, dev),
                ck.shard_valid(valid_chunks, d, self.local_chunks),
            )
            for d, dev in enumerate(self.devices)
        ]
        # gather onto the first shard's device and fold there
        home = self.devices[0]
        limbs = F.words_to_limbs(torch.cat([p.to(home) for p in parts]))
        tot = limbs[0:1]
        for i in range(1, self.n_shards):
            tot = C.point_add_limbs(tot, limbs[i : i + 1])
        return F.limbs_to_words(tot)

    def msm(self, points, words: torch.Tensor, valid_chunks: int
            ) -> RistrettoPoint:
        """:meth:`msm_async`, fetched to the host."""
        return ck.fetch_points([self.msm_async(points, words, valid_chunks)])[0]


class ShardedWalkVerifyBackend:
    """Verifier backend whose mega-MSM G / H generator segments (the
    dominant verification cost) run through :class:`ShardedWalkMsm`;
    the head and tail (proof-specific points) stay on the host, as in the
    reference.  The generators are cached per shard on the shards'
    devices, keyed by ``id(gens_share._gens)`` (and the padded size: the
    reference's cache ignores it, so a second padded size with the same
    generators would reuse the first one's identity padding), padded
    with identity points to the span; words are zero past padded n."""

    def __init__(self, sharded: ShardedWalkMsm):
        self._sh = sharded
        self._big_cache: dict = {}

    def msm(self, scalars, points):
        if isinstance(scalars, np.ndarray):
            scalars = scvec.to_scalars(scalars)
        return multiscalar_mul(list(scalars), points)

    def _gens_big(self, gens_share, padded_n: int, which: str):
        key = (id(gens_share._gens), which, padded_n)
        got = self._big_cache.get(key)
        if got is None:
            span = self._sh.total_chunks * ck.CHUNK
            if padded_n > span:
                raise ValueError(
                    f"padded n {padded_n} exceeds the sharded span {span}"
                )
            raw = (gens_share.G_raw(padded_n) if which == "G"
                   else gens_share.H_raw(padded_n))
            pts = torch.cat([F.from_raw(raw),
                             F.identity_points(span - padded_n)])
            got = self._sh.place(pts)
            self._big_cache[key] = got
        return got

    def _words(self, seg: np.ndarray) -> torch.Tensor:
        span = self._sh.total_chunks * ck.CHUNK
        w = np.zeros((span, 8), np.int32)
        w[: seg.shape[0]] = ck.signed_digit_words(seg)
        return torch.from_numpy(w)

    def msm_gens(
        self, scalars, head_points, gens_share, padded_n, tail_points
    ) -> RistrettoPoint:
        if padded_n % ck.CHUNK:
            raise ValueError(f"padded n {padded_n} is not whole chunks")
        k = padded_n // ck.CHUNK
        nh = len(head_points)
        arr = (
            scalars if isinstance(scalars, np.ndarray)
            else scvec.from_scalars(list(scalars))
        )
        g_end, h_end = nh + padded_n, nh + 2 * padded_n
        accs = [
            self._sh.msm_async(self._gens_big(gens_share, padded_n, which),
                               self._words(arr[a:b]), k)
            for which, a, b in (("G", nh, g_end), ("H", g_end, h_end))
        ]
        G_pt, H_pt = ck.fetch_points(accs)
        rest = multiscalar_mul(
            scvec.to_scalars(arr[:nh]) + scvec.to_scalars(arr[h_end:]),
            head_points + tail_points,
        )
        return G_pt + H_pt + rest
