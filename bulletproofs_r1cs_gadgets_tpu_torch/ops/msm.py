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

The reference's per-shard MSM of its sharded backend,
``msm_chunk_impl(points, digits, window)`` over unsigned base-2^w
window digits (:func:`scalars_to_digits`), is one ``msm_chunk_acc``
launch here: the digits are packed back into the bit words the kernel
reads (:func:`digits_to_words`).

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
WINDOW = 4  # bits per window of the reference's digits
NWINDOWS = (253 + WINDOW - 1) // WINDOW  # 64


def scalar_rows(scalars) -> np.ndarray:
    """Scalars (list of Scalar / int, or (n, 4) u64 rows) -> (n, 4) rows."""
    if isinstance(scalars, np.ndarray):
        return scalars
    return scvec.from_ints([s.v if isinstance(s, Scalar) else int(s)
                            for s in scalars])


def scalars_to_digits(scalars, window: int = WINDOW) -> np.ndarray:
    """(N, NWINDOWS) int32 window digits, least-significant window first.

    Accepts a list of ints or a ``core.scvec`` (N, 4) u64 array; the array
    path is fully vectorized (nibble split of the little-endian byte view —
    no per-scalar Python loop, VERDICT round-1 item 8)."""
    nwin = (253 + window - 1) // window
    if isinstance(scalars, np.ndarray) and scalars.ndim == 2:
        assert window in (1, 2, 4, 8), "array fast path needs window | 8"
        n = scalars.shape[0]
        b = np.ascontiguousarray(scalars, dtype="<u8").view(np.uint8)
        b = b.reshape(n, 32)
        per = 8 // window
        mask = (1 << window) - 1
        out = np.empty((n, 32 * per), dtype=np.int32)
        for k in range(per):
            out[:, k::per] = (b >> (window * k)) & mask
        return out[:, :nwin]
    n = len(scalars)
    out = np.zeros((n, nwin), dtype=np.int32)
    mask = (1 << window) - 1
    for i, s in enumerate(scalars):
        v = s
        for w in range(nwin):
            out[i, w] = v & mask
            v >>= window
    return out


def digits_to_words(digits, window: int = WINDOW) -> np.ndarray:
    """(n, nwin) unsigned base-2^w digits, least significant window first,
    -> (n, 8) int32 bit words (``ck.bit_words``' layout) of the values
    sum_k d_k 2^(w k).  The kernel reads bits 252..0, so a value of 2^253
    or more raises (digits of canonical scalars never reach it)."""
    d = np.asarray(digits)
    n, nwin = d.shape
    if d.size and (d.min() < 0 or d.max() >= 1 << window):
        raise ValueError(f"digits outside [0, 2^{window})")
    nbits = nwin * window
    bits = np.zeros((n, max(256, nbits)), np.uint8)
    for j in range(window):
        bits[:, j:nbits:window] = (d >> j) & 1
    if bits[:, 253:].any():
        raise ValueError("a value of 2^253 or more: the kernel reads bits 252..0")
    by = np.packbits(bits[:, :256], axis=1, bitorder="little")
    return np.ascontiguousarray(by).view("<i4").reshape(n, 8)


def msm_chunk_impl(points: torch.Tensor, digits, window: int = WINDOW
                   ) -> torch.Tensor:
    """MSM over one chunk: points (N, 4, 8), digits (N, W) -> (4, 8) sum,
    on the points' device.  One ``msm_chunk_acc`` launch from the
    identity over the digits' bit words (the JAX package runs a windowed
    double-and-add over the digits in XLA, then a tree)."""
    dev = points.device
    words = torch.from_numpy(digits_to_words(
        digits.cpu().numpy() if isinstance(digits, torch.Tensor) else digits,
        window)).to(dev)
    return cc.msm_chunk_acc(points.contiguous(), words,
                            identity_points((1,), dev))[0]


def msm_words(words: torch.Tensor, points_dev: torch.Tensor, chunk: int,
              acc=None) -> torch.Tensor:
    """sum_i s_i * P_i (+ acc) -> (4, 8) over bit words already on the
    points' device, no sync: one ``msm_chunk_acc`` call per `chunk`
    points, chained through the accumulator."""
    n = points_dev.shape[0]
    dev = points_dev.device
    acc = identity_points((1,), dev) if acc is None else acc.reshape(1, 4, 8)
    for off in range(0, n, chunk):
        hi = min(off + chunk, n)
        acc = cc.msm_chunk_acc(points_dev[off:hi], words[off:hi], acc)
    return acc[0]


def msm_device(scalars, points_dev: torch.Tensor, acc=None) -> torch.Tensor:
    """sum_i s_i * P_i (+ acc) -> (4, 8) on the points' device, no sync:
    the scalars' bit words uploaded, then :func:`msm_words`."""
    n = points_dev.shape[0]
    rows = scalar_rows(scalars)
    assert rows.shape[0] == n
    words = torch.from_numpy(ck.bit_words(rows)).to(points_dev.device)
    return msm_words(words, points_dev, CHUNK, acc)


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
