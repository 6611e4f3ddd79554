"""The port's fixed-point tensors against the JAX package's, on the CPU:
every op of ``fxp/array.py`` on the same seeded codes, integers equal
with tolerance 0 (data, bits, exp, signed). Covers exact ties of the
half-to-even round, negative codes, up-shifts past 31 bits, wide (int64)
and narrow (int32, wrapping) products and dots, int32 sums in
``fxp_mean`` / ``fxp_log_softmax``, and top-k with ties; also the exact
float64 dot of the CUDA path (run here on CPU float64 matmuls) against
the int64 one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.fxp import array as jx
from sparsernns_tpu_torch.fxp import array as tx

MODES = ["FLOOR", "CEIL", "ROUND"]


def _pair(data: np.ndarray, bits=16, exp=8, signed=True):
    """The same codes as a JAX and a port FxpArray."""
    data = np.asarray(data, np.int32)
    return (jx.FxpArray(jnp.asarray(data), bits, exp, signed),
            tx.FxpArray(torch.from_numpy(data.copy()), bits, exp, signed))


def _equal(j, t, what=""):
    """A JAX and a port FxpArray / ComplexFxpArray are the same integers."""
    if isinstance(j, jx.ComplexFxpArray):
        _equal(j.real, t.real, what + ".re")
        _equal(j.imag, t.imag, what + ".im")
        return
    assert (j.bits, j.exp, j.signed) == (t.bits, t.exp, t.signed), what
    want = np.asarray(j.data)
    got = t.data.numpy() if isinstance(t.data, torch.Tensor) else t.data
    assert got.dtype == want.dtype == np.int32, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _codes(seed, shape, bits, ties_at: int = 0):
    """Seeded signed codes over the full range of ``bits``, with exact
    round ties for a shift of ``ties_at`` and both extremes."""
    rng = np.random.RandomState(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    x = rng.randint(lo, hi + 1, size=shape, dtype=np.int64)
    flat = x.reshape(-1)
    flat[:2] = (lo, hi)
    if ties_at:
        n = min(flat.size // 3, 64)
        base = rng.randint(-(1 << (bits - ties_at - 2)),
                           1 << (bits - ties_at - 2), size=n)
        flat[2:2 + n] = base * (1 << ties_at) + (1 << (ties_at - 1))
    return x.astype(np.int32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shift", [1, 3, 12, 20])
def test_rshift_round(mode, shift):
    x = _codes(shift, (400,), 31, ties_at=shift)
    rm = getattr(jx.RoundingMode, mode)
    want = np.asarray(jx.fxp_rshift_round(jnp.asarray(x), shift, rm))
    got = tx.fxp_rshift_round(torch.from_numpy(x), shift,
                              getattr(tx.RoundingMode, mode))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("signed", [True, False])
def test_from_fp(mode, signed):
    rng = np.random.RandomState(3)
    ties = (np.arange(-16, 16) + 0.5) / 256.0
    x = np.concatenate([ties, rng.randn(300) * 40.0]).astype(np.float32)
    beyond = np.concatenate([x, [1e9, -1e9]]).astype(np.float32)
    jr, tr = getattr(jx.RoundingMode, mode), getattr(tx.RoundingMode, mode)
    want = jx.fxp_from_fp(jnp.asarray(beyond), 16, 8, signed, jr)
    _equal(want, tx.fxp_from_fp(torch.from_numpy(beyond), 16, 8, signed, tr))
    # host packing: numpy in, numpy out
    want = jx.fxp_from_fp(x, 12, 6, signed, jr)
    got = tx.fxp_from_fp(x, 12, 6, signed, tr)
    assert isinstance(got.data, np.ndarray)
    _equal(want, got)


@pytest.mark.parametrize("bits,exp,new_exp", [
    (16, 8, 12), (16, 4, 24),          # up, and up past 31 bits (wide)
    (31, 2, 20), (16, 12, 3),          # wide up from 31 bits; down
    (24, 20, 1)])
@pytest.mark.parametrize("mode", MODES)
def test_change_exp_and_cfg(bits, exp, new_exp, mode):
    j, t = _pair(_codes(bits + exp, (300,), bits, ties_at=max(1, exp - new_exp)),
                 bits, exp)
    jr, tr = getattr(jx.RoundingMode, mode), getattr(tx.RoundingMode, mode)
    _equal(jx.fxp_change_exp(j, new_exp, jr),
           tx.fxp_change_exp(t, new_exp, tr), "change_exp")
    for nb, ns in ((8, True), (12, False), (bits, True)):
        _equal(jx.fxp_change_cfg(j, nb, new_exp, ns, jr),
               tx.fxp_change_cfg(t, nb, new_exp, ns, tr), f"cfg {nb} {ns}")


@pytest.mark.parametrize("b1,e1,b2,e2", [
    (16, 8, 16, 12), (16, 8, 8, 3),     # aligned, narrow
    (32, 10, 16, 4), (30, 2, 30, 9)])   # wide: the sum passes int32
def test_add_sub(b1, e1, b2, e2):
    j1, t1 = _pair(_codes(1, (6, 50), b1), b1, e1)
    j2, t2 = _pair(_codes(2, (50,), b2), b2, e2, signed=False
                   if b2 == 8 else True)
    _equal(jx.fxp_add(j1, j2), tx.fxp_add(t1, t2), "add")
    _equal(jx.fxp_sub(j1, j2), tx.fxp_sub(t1, t2), "sub")
    for kw in (dict(result_bits=32), dict(result_bits=16, result_exp=6,
                                          round_mode="ROUND"),
               dict(result_bits_add=1, result_exp=e1)):
        jkw, tkw = dict(kw), dict(kw)
        if "round_mode" in kw:
            jkw["round_mode"] = jx.RoundingMode.ROUND
            tkw["round_mode"] = tx.RoundingMode.ROUND
        _equal(jx.fxp_add(j1, j2, **jkw), tx.fxp_add(t1, t2, **tkw),
               f"add {kw}")
        _equal(jx.fxp_sub(j1, j2, **jkw), tx.fxp_sub(t1, t2, **tkw),
               f"sub {kw}")


@pytest.mark.parametrize("b1,b2", [(8, 16), (15, 15), (16, 16), (31, 12)])
@pytest.mark.parametrize("mode", MODES)
def test_mul(b1, b2, mode):
    j1, t1 = _pair(_codes(5, (4, 64), b1), b1, 7)
    j2, t2 = _pair(_codes(6, (64,), b2), b2, 11)
    jr, tr = getattr(jx.RoundingMode, mode), getattr(tx.RoundingMode, mode)
    for exp in (None, 18, 9, 0):
        _equal(jx.fxp_mul(j1, j2, result_exp=exp, round_mode=jr),
               tx.fxp_mul(t1, t2, result_exp=exp, round_mode=tr),
               f"mul exp {exp}")
    _equal(jx.fxp_mul(j1, j2, result_bits=32, result_exp=12, round_mode=jr),
           tx.fxp_mul(t1, t2, result_bits=32, result_exp=12, round_mode=tr))
    with pytest.raises(ValueError):
        tx.fxp_mul(t1, t2, result_exp=19)


@pytest.mark.parametrize("b1,b2,k", [
    (16, 16, 257),                      # 16 x 16 bits: the int64 path
    (8, 16, 192), (16, 8, 257),
    (15, 15, 4096),                     # narrow: the int32 accumulator wraps
    (12, 12, 33)])
@pytest.mark.parametrize("mode", MODES)
def test_matmul(b1, b2, k, mode):
    j1, t1 = _pair(_codes(7, (3, 5, k), b1), b1, 9)
    j2, t2 = _pair(_codes(8, (k, 6), b2), b2, 7)
    jr, tr = getattr(jx.RoundingMode, mode), getattr(tx.RoundingMode, mode)
    for kw in (dict(result_bits=32, result_exp=10),
               dict(result_bits=16, result_exp=3),
               dict(result_bits=32, result_exp=20),   # rshift < 0
               dict()):
        _equal(jx.fxp_matmul(j1, j2, round_mode=jr, **kw),
               tx.fxp_matmul(t1, t2, round_mode=tr, **kw), f"matmul {kw}")
    if (b1, b2) == (15, 15):
        exact = _codes(7, (3, 5, k), b1).astype(np.int64) @ \
            _codes(8, (k, 6), b2).astype(np.int64)
        assert np.abs(exact).max() > 2 ** 31   # the accumulator wraps


@pytest.mark.parametrize("bits,k", [(8, 4096), (16, 257), (31, 257)])
def test_float64_dot_of_the_cuda_path_is_exact(bits, k):
    """The CUDA path's float64 dot (whole, or in 16-bit limbs past 2^53),
    run on CPU float64 matmuls, equals the int64 dot, int32 and int64."""
    a = torch.from_numpy(_codes(9, (7, k), bits)).to(torch.int64)
    b = torch.from_numpy(_codes(10, (k, 5), bits)).to(torch.int64)
    mag = 2 * (bits - 1)
    for dtype in (torch.int32, torch.int64):
        want = tx._int_dot(a, b, dtype, mag, float64=False)
        got = tx._int_dot(a, b, dtype, mag, float64=True)
        assert torch.equal(got, want), (bits, k, dtype)
    assert (a @ b).abs().max() > 2 ** 31 or bits == 8


def test_complex_mul():
    jr, tr = _pair(_codes(11, (40,), 16), 16, 14)
    ji, ti = _pair(_codes(12, (40,), 16), 16, 14)
    jw, tw = _pair(_codes(13, (40,), 16), 16, 9)
    jv, tv = _pair(_codes(14, (40,), 16), 16, 9)
    a = (jx.ComplexFxpArray(jr, ji), tx.ComplexFxpArray(tr, ti))
    b = (jx.ComplexFxpArray(jw, jv), tx.ComplexFxpArray(tw, tv))
    _equal(jx.fxp_complex_mul(a[0], b[0]), tx.fxp_complex_mul(a[1], b[1]))
    kw = dict(result_exp=(12, 10), result_bits=(16, 20))
    _equal(jx.fxp_complex_mul(a[0], b[0], round_mode=jx.RoundingMode.ROUND,
                              **kw),
           tx.fxp_complex_mul(a[1], b[1], round_mode=tx.RoundingMode.ROUND,
                              **kw))


@pytest.mark.parametrize("k", [1, 3, 8, 15])
def test_relu_and_top_k_with_ties(k):
    rng = np.random.RandomState(k)
    x = rng.randint(-5, 6, size=(4, 3, 16)).astype(np.int32)   # many ties
    j, t = _pair(x, 16, 4)
    _equal(jx.fxp_relu(j), tx.fxp_relu(t), "relu")
    _equal(jx.fxp_top_k(j, k), tx.fxp_top_k(t, k), "top_k")
    _equal(jx.fxp_relu_top_k(j, k), tx.fxp_relu_top_k(t, k), "relu_top_k")
    assert tx.fxp_top_k(t, 16) is t
    ji, ti = _pair(x[::-1].copy(), 16, 4)
    _equal(jx.fxp_relu_top_k(jx.ComplexFxpArray(j, ji), k),
           tx.fxp_relu_top_k(tx.ComplexFxpArray(t, ti), k), "complex")


@pytest.mark.parametrize("n,bits,exp", [
    (4, 16, 10), (10, 16, 6), (257, 16, 12),
    (6, 12, 1),              # exp below the table's: widened first
    (3000, 24, 16)])         # wide head, int32 sum of the exp table
def test_log_softmax(n, bits, exp):
    j, t = _pair(_codes(n + exp, (3, n), bits), bits, exp)
    _equal(jx.fxp_log_softmax(j), tx.fxp_log_softmax(t))
    _equal(jx.fxp_log_softmax(j, out_bits=20, out_exp=14),
           tx.fxp_log_softmax(t, out_bits=20, out_exp=14))


@pytest.mark.parametrize("bits,n,axis", [
    (16, 24, 0), (16, 7, 1), (31, 16, 1),   # the int32 sum wraps at 31 bits
    (12, 100, 2)])
def test_mean(bits, n, axis):
    shape = [3, 4, 5]
    shape[axis] = n
    j, t = _pair(_codes(bits + n, tuple(shape), bits), bits, 9)
    _equal(jx.fxp_mean(j, axis=axis), tx.fxp_mean(t, axis=axis))
    _equal(jx.fxp_mean(j, axis=axis, round_mode=jx.RoundingMode.FLOOR),
           tx.fxp_mean(t, axis=axis, round_mode=tx.RoundingMode.FLOOR))


def test_overflow_count_and_to_float():
    x = np.array([-300, -128, 0, 127, 128, 5000], np.int32)
    j, t = _pair(x, 8, 3)
    assert int(tx.overflow_count(t)) == int(j.overflow_count()) == 3
    np.testing.assert_array_equal(t.to_float().numpy(),
                                  np.asarray(j.to_float()))
    _equal(j.clip(), t.clip())
