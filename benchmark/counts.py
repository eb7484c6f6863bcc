"""The least device time of a proof's group operations, from its shapes.

The yardstick of ``kernel_roofline.prove``.  It depends only on the
proof's shapes (the multipliers n and the padded size N = 2^k), never on
which kernels run, and every count is a floor that no implementation
undercuts:

* an MSM of m scalar-point pairs with 253-bit scalars at the fewest point
  additions of a bucket method at its best window c: ceil(253 / c)
  windows, each adding the m points into 2^(c-1) signed buckets (the
  first point of a bucket costs nothing) and summing the buckets (2^c - 2
  additions), plus c doublings between windows; for the few pairs of the
  last IPP rounds a joint signed-window ladder is cheaper, and the lesser
  of the two counts;
* a generator fold out = beta * D_L + alpha * D_R with half-width
  scalars (|alpha|, |beta| ~ 2^126, the half-gcd split of the round's
  constant) at 126 doublings and the additions of a joint windowed
  ladder at its best window w: 2^(w-1) - 2 additions for the two tables
  of odd multiples and 2 ceil(126 / (w + 1)) digit additions;
* an addition at the cheapest formula in use, the niels add (8 field
  multiplies of 73 products of 32 x 32 bits, each two 32-bit multiplies),
  a doubling at 4 squares of 45 products and 3 multiplies (T dropped);
* each operation's time is the larger of its 32-bit multiplies over the
  card's multiply rate and its bytes (inputs read once, outputs written
  once: 128 B a point, 32 B a scalar) over the memory rate.

A proof's operations: the three phase-1 commitments (A_I over 2n pairs,
A_O over n, S over 2n), each IPP round j = 1..k at m = N / 2^j (L and R
over 2m pairs each; in round 1 a_R is zero beyond n, so R has n pairs)
and the folds of both generator sides after each round while m > 1024
(below that an implementation may stop folding and walk the unfolded
generators, which costs more MSM pairs than the folds save).
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM: 32-bit integer multiplies, 64 a clock per SM (CUDA C++
# Programming Guide, compute capability 9.0) x 132 SMs x 1,980 MHz maximum
# SM clock; HBM3 at 3.35 TB/s (data sheet).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int_muls_per_s": 64 * 132 * 1980e6,
                              "bytes_per_s": 3.35e12},
}
SCALAR_BITS = 253
HALF_BITS = 126
FE_MUL = 2 * 73  # 32-bit multiplies of a field multiply
FE_SQ = 2 * 45  # of a field square
ADD = 8 * FE_MUL  # niels addition
DBL = 4 * FE_SQ + 3 * FE_MUL  # doubling without T
POINT_BYTES = 128
SCALAR_BYTES = 32
FROZEN_SIDE = 1024


def msm_ops(pairs: int, bits: int = SCALAR_BITS) -> tuple[int, int]:
    """(additions, doublings) of the cheapest MSM over `pairs`: a bucket
    method at its best window, or for few pairs, where that is cheaper, a
    joint ladder over signed windows (each point's odd multiples, one
    addition a nonzero digit of density 1 / (w + 1), shared doublings)."""
    best = None
    for c in range(1, 31):
        windows = math.ceil(bits / c)
        adds = windows * (max(pairs - (1 << (c - 1)), 0) + (1 << c) - 2)
        dbls = c * (windows - 1)
        cost = adds * ADD + dbls * DBL
        if best is None or cost < best[0]:
            best = (cost, adds, dbls)
    for w in range(2, 9):
        adds = pairs * ((1 << (w - 2)) - 1 + math.ceil(bits / (w + 1)))
        dbls = bits - 1 + pairs
        cost = adds * ADD + dbls * DBL
        if cost < best[0]:
            best = (cost, adds, dbls)
    return best[1], best[2]


def fold_ops(outputs: int, bits: int = HALF_BITS) -> tuple[int, int]:
    """(additions, doublings) of `outputs` half-width two-point folds."""
    adds = min((1 << (w - 1)) - 2 + 2 * math.ceil(bits / (w + 1))
               for w in range(2, 9))
    return outputs * adds, outputs * bits


def _seconds(adds: int, dbls: int, nbytes: int, peaks: dict) -> float:
    muls = adds * ADD + dbls * DBL
    return max(muls / peaks["int_muls_per_s"], nbytes / peaks["bytes_per_s"])


def prove_operations(n: int, padded: int) -> list[tuple[str, int, int, int]]:
    """[(name, additions, doublings, bytes)] of one proof's group
    operations at n multipliers padded to `padded`."""
    ops = []

    def msm(name, pairs):
        a, d = msm_ops(pairs)
        ops.append((name, a, d, pairs * (POINT_BYTES + SCALAR_BYTES)
                    + POINT_BYTES))

    msm("phase1.A_I", 2 * n)
    msm("phase1.A_O", n)
    msm("phase1.S", 2 * n)
    k = padded.bit_length() - 1
    for j in range(1, k + 1):
        m = padded >> j
        msm(f"ipp{j}.L", 2 * m)
        msm(f"ipp{j}.R", (n - m if j == 1 else m) + m)
        if j < k and m > FROZEN_SIDE:
            a, d = fold_ops(2 * m)
            ops.append((f"ipp{j}.fold", a, d, 2 * m * 3 * POINT_BYTES))
    return ops


def prove_floor_s(n: int, padded: int, peaks: dict) -> float:
    """The least device seconds of one proof's group operations."""
    return sum(_seconds(a, d, b, peaks)
               for _, a, d, b in prove_operations(n, padded))
