"""The operation and byte counts of ``benchmark/cost`` against hand counts
at the recipe's shapes, and the peak table."""

import pytest

from benchmark.cost.model import Shape, k2, k3b, k6, model_forward_flops
from benchmark.cost.peaks import least_seconds, peaks

B8 = Shape(8, 3751, 257, 192, 128, 3)
B32 = Shape(32, 3751, 257, 192, 128, 3)


def test_model_forward_flops_at_b8_is_30_5_gflop():
    assert model_forward_flops(B8) == pytest.approx(30.54e9, rel=1e-3)


def test_model_forward_flops_by_hand():
    bl = 32 * 3751
    enc = dec = 2 * bl * 257 * 192
    layer = (2 * bl * 192 * 256 * 2 + 8 * bl * 128 + 8 * bl * 192
             + 2 * bl * 192 * 192 + 3 * bl * 192)
    assert model_forward_flops(B32) == enc + 3 * layer + dec


def test_k2_by_hand():
    bl = 32 * 3751
    flops = (2 * bl * 192 * 256 * 2 + 8 * bl * 128 + 8 * bl * 192
             + 2 * bl * 192 * 192 + 3 * bl * 192)
    nbytes = 2 * 4 * bl * 192 + 4 * (2 * 192 * 256 + 192 * 192 + 256
                                     + 6 * 192)
    assert k2(B32) == (flops, nbytes)
    # bytes bound: 0.055 ms at B = 32
    assert least_seconds(*k2(B32), "NVIDIA H100 80GB HBM3") == \
        pytest.approx(0.0551e-3, rel=1e-2)


def test_k3b_by_hand():
    bl = 32 * 3751
    proj, gate = 2 * bl * 192 * 256, 2 * bl * 192 * 192
    assert k3b(B32).flops == 5 * proj + 3 * gate + 8 * bl * 128 + 20 * bl * 192
    assert k3b(B32).flops == pytest.approx(86.1e9, rel=1e-2)
    assert k3b(B32).bytes == 4 * bl * (3 * 192 + 2 * 128) + 4 * (
        2 * 192 * 256 + 192 * 192 + 256 + 6 * 192)
    # the bytes bound, 0.119 ms, is the larger
    assert least_seconds(*k3b(B32), "NVIDIA H100 80GB HBM3") == \
        pytest.approx(k3b(B32).bytes / 3.35e12)


def test_k6_by_hand():
    bl = 32 * 3751
    assert k6(B32).flops == model_forward_flops(B32)
    assert k6(B32).bytes == 2 * 4 * bl * 257 + 257 * 192 * 2 + 3 * (
        2 * 192 * 256 + 192 * 192)
    assert least_seconds(*k6(B32), "NVIDIA H100 80GB HBM3") == \
        pytest.approx(0.1236e-3, rel=1e-2)


def test_peaks_of_the_h100_and_no_guess_elsewhere():
    assert peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    with pytest.raises(ValueError):
        peaks("NVIDIA A100-SXM4-80GB")
