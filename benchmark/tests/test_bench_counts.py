"""The floors of ``kernel_roofline.prove`` sit at or below the work that
the port's kernels do today at the same shapes, so the share cannot pass
100%.  The kernels' counts are copied as data from ``chip_smoke.py``'s
operation counts (``walk_ops``, ``msm_w4_ops``, ``fold_w3h_ops``): per
scalar-point pair, one niels add per nonzero digit (w5 digits over the
shared tables: 51 windows, 31 of 32 codes nonzero; w4 digits: 64 windows,
15 of 16), and per pair its table (3 niels adds, 4 doublings) and per
walk its 64 window sums and Horner's 252 doublings; per half-width fold output, 3 doublings a base-8 window over
44 windows and one niels add per nonzero digit of either scalar (7 of 8)."""

import pytest

from benchmark import counts

W5_ADDS_PER_PAIR = 51 * 31 / 32
W4_ADDS_PER_PAIR = 64 * 15 / 16
FOLD_DBLS_PER_OUTPUT = 3 * 44
FOLD_ADDS_PER_OUTPUT = 2 * 44 * 7 / 8
SHAPES = [(143_704, 1 << 18), (74_624, 1 << 17), (4_544, 1 << 13)]


@pytest.mark.parametrize("n,padded", SHAPES)
def test_each_floor_is_below_the_kernels_work(n, padded):
    for name, adds, dbls, nbytes in counts.prove_operations(n, padded):
        if name.endswith(".fold"):
            outputs = nbytes // (3 * counts.POINT_BYTES)
            assert dbls <= outputs * FOLD_DBLS_PER_OUTPUT, name
            assert adds <= outputs * FOLD_ADDS_PER_OUTPUT, name
            continue
        pairs = (nbytes - counts.POINT_BYTES) // (
            counts.POINT_BYTES + counts.SCALAR_BYTES)
        shared = name.startswith(("phase1", "ipp1."))
        per = W5_ADDS_PER_PAIR if shared else W4_ADDS_PER_PAIR
        assert adds <= pairs * (per + 3) + 64, name
        assert adds * counts.ADD + dbls * counts.DBL <= (
            (pairs * (per + 3) + 64) * counts.ADD
            + (4 * pairs + 252) * counts.DBL), name


@pytest.mark.parametrize("n,padded", SHAPES)
def test_the_floor_depends_on_shapes_alone(n, padded):
    peaks = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    a = counts.prove_floor_s(n, padded, peaks)
    assert a == counts.prove_floor_s(n, padded, peaks) > 0
    assert counts.prove_floor_s(n, 2 * padded, peaks) > a


def test_msm_floor_is_the_best_bucket_window_at_size():
    adds, dbls = counts.msm_ops(1 << 18)
    for c in (8, 12, 20):  # any other window costs at least as much
        w = -(-253 // c)
        other = w * ((1 << 18) - (1 << (c - 1)) + (1 << c) - 2)
        assert adds * counts.ADD + dbls * counts.DBL <= \
            other * counts.ADD + c * (w - 1) * counts.DBL
