"""The port's integer dots (``sparsernns_tpu_torch/ops/intdot.py``) against
the JAX package's ``sparsernns_tpu/ops/intdot.py``, on the CPU: codes,
planes, column sums and the dot's accumulator, all BIT FOR BIT (integer
arithmetic; the one float32 add of the plane-wise formula rounds alike),
at 4, 8, 12 and 16 bits over K = 96, 257, 384 (one int32 accumulator at
16 bits) and 640 (plane-wise), with codes at both ends of the 16-bit grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops import intdot as jax_intdot
from sparsernns_tpu_torch.ops import intdot


def _weight(rng, k, n):
    """int8 weights reaching both ends, -128 and 127."""
    w = rng.randint(-128, 128, size=(k, n)).astype(np.int8)
    w[0, 0], w[1, 0] = -128, 127
    return w


def _activations(rng, k, scale, bits):
    """Activations over the grid and beyond its clip, with exact ties."""
    qmax = 2 ** (bits - 1)
    x = rng.randn(3, k) * qmax * scale / 2
    x[0, :8] = (np.arange(8) - 3.5) * scale          # ties at .5
    x[1, :4] = [-2.0 * qmax * scale, 2.0 * qmax * scale,
                -qmax * scale, (qmax - 1) * scale]  # clipped, both ends
    return x.astype(np.float32)


@pytest.mark.parametrize("k", [96, 257, 384, 640])
@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_int16_dot_equals_jax(bits, k):
    """Codes, planes, colsum and the accumulator of x quantized at (scale,
    bits) against JAX's, exactly."""
    rng = np.random.RandomState(bits * 1000 + k)
    scale = 2.0 ** -6
    x = _activations(rng, k, scale, bits)
    w = _weight(rng, k, 40)
    codes = intdot.quantize_codes(torch.from_numpy(x), scale, bits)
    ref_codes = jax_intdot.quantize_codes(jnp.asarray(x), scale, bits)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    cs = intdot.weight_colsum(torch.from_numpy(w))
    assert cs.dtype == torch.int32
    np.testing.assert_array_equal(cs.numpy(),
                                  np.asarray(jax_intdot.weight_colsum(w)))
    acc = intdot.int16_dot(torch.from_numpy(x), torch.from_numpy(w), cs,
                           scale, bits)
    ref = jax_intdot.int16_dot(jnp.asarray(x), jnp.asarray(w),
                               jax_intdot.weight_colsum(w), scale, bits)
    assert acc.dtype == torch.float32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref))
    # the planes of 9..16-bit codes
    if bits > 8:
        hi, lo = intdot.i16_planes(codes)
        ref_hi, ref_lo = jax_intdot.i16_planes(ref_codes)
        np.testing.assert_array_equal(hi.numpy(), np.asarray(ref_hi))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(ref_lo))
        assert (hi.to(torch.int32) * 256 + lo.to(torch.int32) + 128
                == codes.to(torch.int32)).all()


@pytest.mark.parametrize("k", [384, 640, 2048])
def test_codes_at_both_ends_of_the_16_bit_grid(k):
    """Codes -32768 and 32767 against weights -128 and 127: the extremes
    the int32 budget counts on (hi = -128, lo - 128 = -128 at -32768);
    the ``codes=`` argument skips the quantization; exactly JAX's, and the
    single-accumulator value is the exact integer dot."""
    rng = np.random.RandomState(k)
    q = np.full((2, k), -32768.0, np.float32)
    q[1, ::2] = 32767.0
    w = np.full((k, 3), -128, np.int8)
    w[:, 1] = 127
    w[:, 2] = _weight(rng, k, 1)[:, 0]
    hi, lo = intdot.i16_planes(torch.from_numpy(q))
    assert hi[0, 0] == -128 and lo[0, 0] == -128
    acc = intdot.int16_dot(None, torch.from_numpy(w),
                           intdot.weight_colsum(w), 1.0, 16,
                           codes=torch.from_numpy(q))
    ref = jax_intdot.int16_dot(jnp.zeros((2, k)), jnp.asarray(w),
                               jax_intdot.weight_colsum(w), 1.0, 16,
                               codes=jnp.asarray(q))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref))
    exact = q.astype(np.float64) @ w.astype(np.float64)
    if intdot.fits_int32(k):
        np.testing.assert_array_equal(acc.numpy(), exact.astype(np.float32))
    else:
        # plane-wise: one float32 add of two exact terms
        assert np.abs(acc.numpy() - exact).max() <= 2.0 ** -23 * np.abs(
            exact).max()


def test_budget_tables_and_the_plane_wise_limit():
    """fits_int32 / fits_planewise / the formula per width equal JAX's
    tables; a reduction dim past 65536 raises ValueError in both."""
    for k in (1, 128, 384, 511, 512, 640, 65536, 65537):
        for bits in (8, 12, 16):
            assert intdot.fits_int32(k, bits) == jax_intdot.fits_int32(
                k, bits), (k, bits)
        assert intdot.fits_planewise(k) == jax_intdot.fits_planewise(k)
    assert intdot.MAX_REDUCTION_DIM == jax_intdot.MAX_REDUCTION_DIM
    assert intdot.dot_formula(65537, 8) == intdot.DOT_I8
    assert intdot.dot_formula(511, 16) == intdot.DOT_I16
    assert intdot.dot_formula(512, 16) == intdot.DOT_I16_PLANES
    assert intdot.dot_formula(4095, 12) == intdot.DOT_I16
    w = np.ones((65537, 1), np.int8)
    x = np.ones((1, 65537), np.float32)
    with pytest.raises(ValueError, match="65536"):
        intdot.int16_dot(torch.from_numpy(x), torch.from_numpy(w),
                         intdot.weight_colsum(w), 1.0, 16)
    with pytest.raises(ValueError, match="65536"):
        jax_intdot.int16_dot(jnp.asarray(x), jnp.asarray(w),
                             jax_intdot.weight_colsum(w), 1.0, 16)


def test_reduction_dim_picks_the_formula():
    """``reduction_dim`` selects the formula where the TPU kernels pad the
    operand: the port's K = 400 with reduction_dim 512 equals JAX's dot on
    the zero-padded K = 512 (plane-wise). (At K <= 514 each plane's sum
    stays below 2^24, so the two formulas also agree in value.)"""
    rng = np.random.RandomState(3)
    x = (rng.randint(-32768, 32768, size=(8, 400)) * 2.0 ** -4).astype(
        np.float32)
    w = _weight(rng, 400, 64)
    cs = intdot.weight_colsum(w)
    acc = intdot.int16_dot(torch.from_numpy(x), torch.from_numpy(w), cs,
                           2.0 ** -4, 16, reduction_dim=512)
    x_pad = np.pad(x, ((0, 0), (0, 112)))
    w_pad = np.pad(w, ((0, 112), (0, 0)))
    ref = jax_intdot.int16_dot(jnp.asarray(x_pad), jnp.asarray(w_pad),
                               jax_intdot.weight_colsum(w_pad), 2.0 ** -4,
                               16)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref))
