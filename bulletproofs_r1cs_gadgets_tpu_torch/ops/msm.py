"""Multi-scalar multiplication on the device-oracle path.

The JAX package's ``ops/msm.py`` runs a windowed double-and-add in XLA
over fixed 2^14-point chunks and adds the chunk partials with
``point_add``.  Here each chunk is one ``msm_chunk_acc`` call (the
windowed w4 MSM over the chunk's bit words, chained on the incoming
accumulator), so the chunk loop chains through the accumulator on the
device with no sync (:func:`msm_device`).  :class:`MsmEngine` caches
generator tensors and runs an MSM as ONE ``msm_block_totals`` call, then
adds the few 2048-point block totals on the host (pallas_curve.py:254).  Scalars are bit words
(``ck.bit_words``), zero-copy from ``core/scvec`` rows.

Correctness oracle: ``core.ristretto.multiscalar_mul`` (host Pippenger).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import scvec
from ..core.ristretto import RistrettoPoint
from ..core.scalar import Scalar
from . import chunks as ck
from . import cuda_curve as cc
from .curve import identity_points, points_from_device, points_to_device

CHUNK = 1 << 14  # points per chained call (the JAX package's chunk)


def scalar_rows(scalars) -> np.ndarray:
    """Scalars (list of Scalar / int, or (n, 4) u64 rows) -> (n, 4) rows."""
    if isinstance(scalars, np.ndarray):
        return scalars
    return scvec.from_ints([s.v if isinstance(s, Scalar) else int(s)
                            for s in scalars])


def msm_device(scalars, points_dev: torch.Tensor, acc=None) -> torch.Tensor:
    """sum_i s_i * P_i (+ acc) -> (4, 8) on the points' device, no sync:
    one ``msm_chunk_acc`` call per CHUNK points, chained through the
    accumulator."""
    n = points_dev.shape[0]
    rows = scalar_rows(scalars)
    assert rows.shape[0] == n
    dev = points_dev.device
    acc = identity_points((1,), dev) if acc is None else acc.reshape(1, 4, 8)
    if n == 0:
        return acc[0]
    words = torch.from_numpy(ck.bit_words(rows)).to(dev)
    for off in range(0, n, CHUNK):
        hi = min(off + CHUNK, n)
        acc = cc.msm_chunk_acc(points_dev[off:hi], words[off:hi], acc)
    return acc[0]


class MsmEngine:
    """Caches device tensors of fixed generator vectors across calls."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._cache: dict[int, torch.Tensor] = {}

    def device_points(self, points: list[RistrettoPoint]) -> torch.Tensor:
        key = id(points)
        hit = self._cache.get(key)
        if hit is not None and hit.shape[0] == len(points):
            return hit
        dev = points_to_device(points, self.device)
        self._cache[key] = dev
        return dev

    def msm(self, scalars, points: list[RistrettoPoint]) -> RistrettoPoint:
        """One ``msm_block_totals`` launch, then the host sums the
        block totals."""
        dev = self.device_points(points)
        words = torch.from_numpy(ck.bit_words(scalar_rows(scalars)))
        totals = points_from_device(
            cc.msm_block_totals(dev, words.to(self.device))
        )
        acc = RistrettoPoint.identity()
        for t in totals:
            acc = acc + t
        return acc
